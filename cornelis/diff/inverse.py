"""Inverse rendering: recover scene parameters from a target image.

The flagship "training" workload (BASELINE.json config 4): given a rendered
(or photographed) target, optimize material/geometry parameters by gradient
descent through the differentiable renderer. This is also the program whose
sharded train step `__graft_entry__.dryrun_multichip` compiles over a
device mesh.

Parameterization: optimizable leaves live in unconstrained space --
sigmoid for albedo/tint (must stay in [0,1]), softplus for emission and
roughness (nonnegative) -- so plain Adam steps can't leave the physical
domain.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Sequence

import jax
import jax.numpy as jnp
import optax

from ..math.vec import Vec3
from ..scene.compile import SceneArrays
from .render import render_diff

Array = jnp.ndarray

# SceneArrays fields that may be optimized, with their domain transform.
_UNIT_FIELDS = ("mat_albedo", "mat_tint")  # sigmoid -> (0, 1)
_POSITIVE_FIELDS = ("mat_emission", "mat_roughness")  # softplus -> (0, inf)
_FREE_FIELDS = (
    "sphere_center",
    "sphere_radius",
    "plane_point",
)  # identity

OPTIMIZABLE_FIELDS = _UNIT_FIELDS + _POSITIVE_FIELDS + _FREE_FIELDS

_EPS = 1e-6


def _to_unconstrained(field: str, value):
    def fwd(x):
        if field in _UNIT_FIELDS:
            x = jnp.clip(x, _EPS, 1.0 - _EPS)
            return jnp.log(x) - jnp.log1p(-x)  # logit
        if field in _POSITIVE_FIELDS:
            x = jnp.maximum(x, _EPS)
            return x + jnp.log(-jnp.expm1(-x))  # softplus inverse
        return x

    if isinstance(value, Vec3):
        return Vec3(fwd(value.x), fwd(value.y), fwd(value.z))
    return fwd(value)


def _to_constrained(field: str, value):
    def fwd(x):
        if field in _UNIT_FIELDS:
            return jax.nn.sigmoid(x)
        if field in _POSITIVE_FIELDS:
            return jax.nn.softplus(x)
        return x

    if isinstance(value, Vec3):
        return Vec3(fwd(value.x), fwd(value.y), fwd(value.z))
    return fwd(value)


def extract_params(scene: SceneArrays, fields: Sequence[str]) -> Dict[str, Any]:
    """Pull the chosen fields out of a scene as an unconstrained pytree."""
    bad = set(fields) - set(OPTIMIZABLE_FIELDS)
    if bad:
        raise ValueError(
            f"not optimizable: {sorted(bad)}; choose from {OPTIMIZABLE_FIELDS}"
        )
    return {f: _to_unconstrained(f, getattr(scene, f)) for f in fields}


def apply_params(scene: SceneArrays, params: Dict[str, Any]) -> SceneArrays:
    """Write unconstrained params back into a scene (domain-transformed)."""
    return scene._replace(
        **{f: _to_constrained(f, v) for f, v in params.items()}
    )


class InverseState(NamedTuple):
    params: Dict[str, Any]
    opt_state: Any
    step: Array


def make_loss(
    base_scene: SceneArrays,
    target: Array,
    *,
    width: int,
    height: int,
    spp: int,
    max_depth: int = 8,
    key_strategy: str = "dual",
    weight: Array | None = None,
    mode: str = "path",
):
    """MSE-vs-target loss over unconstrained params.

    key_strategy:
      * "dual" (default): two renders with independent keys,
        loss = mean((A - t)(B - t)). Plain MSE of a *noisy* render is
        biased -- it rewards parameters that reduce the estimator's
        variance (darker scenes render less noisily), and measurably drags
        albedo toward black; the cross term is an unbiased estimate of the
        MSE of the *expected* image. Costs 2x per step.
      * "per_step": fresh key each step, naive MSE (biased, cheap).
      * "fixed": one key forever -- deterministic optimization of a fixed
        MC estimate; exact gradients, but overfits that noise realization
        (fine when the target was rendered with the same key).

    mode: forwarded to render_diff -- "nee" optimizes against the
    next-event-estimation estimator (detached light sampling), whose
    gradient variance at equal spp is far below path mode's for
    small-emitter scenes (round-5 measurement in PERF.md 2b). Note the
    two modes converge to slightly different images (the path mode
    replicates the reference's quirk pdf, README "estimator-mean
    offset"), so the target should be rendered with the SAME mode.

    weight: optional (H, W) or (H, W, 1/3) per-pixel loss weight. The
    essential use: targets recovered from 8-BIT IMAGES clip at 1.0, but
    the render produces physical radiance (a visible emitter is ~15 in
    Cornell) -- unweighted MSE there is dominated by a constant
    clipped-vs-physical mismatch that swamps every real gradient (round-4
    measurement: loss floor 3.9 from the ~2% light-disc pixels alone, and
    albedo DIVERGED). Zero-weight the clipped pixels and optimize the
    rest.
    """
    if key_strategy not in ("dual", "per_step", "fixed"):
        raise ValueError(f"unknown key_strategy {key_strategy!r}")
    if weight is not None:
        weight = jnp.asarray(weight)
        if weight.ndim == 2:
            weight = weight[:, :, None]
        # Mean over the weighted mass, not the full frame, so the loss
        # scale is comparable with and without a mask.
        norm = jnp.maximum(jnp.mean(weight), 1e-8)

    def _render(scene, key):
        return render_diff(
            scene,
            key,
            width=width,
            height=height,
            spp=spp,
            max_depth=max_depth,
            mode=mode,
        )

    def _mse(prod: Array) -> Array:
        if weight is None:
            return jnp.mean(prod)
        return jnp.mean(prod * weight) / norm

    def loss_fn(params: Dict[str, Any], key: Array) -> Array:
        scene = apply_params(base_scene, params)
        if key_strategy == "dual":
            ka, kb = jax.random.split(key)
            a = _render(scene, ka) - target
            b = _render(scene, kb) - target
            return _mse(a * b)
        img = _render(scene, key)
        return _mse((img - target) ** 2)

    return loss_fn


class InverseRenderer:
    """Adam-on-MSE inverse rendering driver.

    >>> inv = InverseRenderer(scene, target, fields=("mat_albedo",),
    ...                       width=64, height=64, spp=32)
    >>> for _ in range(100): loss = inv.step()
    >>> recovered = inv.scene()
    """

    def __init__(
        self,
        scene: SceneArrays,
        target: Array,
        fields: Sequence[str] = ("mat_albedo",),
        *,
        width: int,
        height: int,
        spp: int,
        max_depth: int = 8,
        learning_rate: float = 5e-2,
        seed: int = 0,
        key_strategy: str = "dual",
        weight: Array | None = None,
        mode: str = "path",
    ):
        self.base_scene = scene
        self.optimizer = optax.adam(learning_rate)
        params = extract_params(scene, fields)
        self.state = InverseState(
            params=params,
            opt_state=self.optimizer.init(params),
            step=jnp.zeros((), jnp.int32),
        )
        self._root_key = jax.random.key(seed)
        loss_fn = make_loss(
            target=jnp.asarray(target),
            base_scene=scene,
            width=width,
            height=height,
            spp=spp,
            max_depth=max_depth,
            key_strategy=key_strategy,
            weight=weight,
            mode=mode,
        )
        fixed = key_strategy == "fixed"

        @jax.jit
        def train_step(state: InverseState, root_key):
            key = root_key if fixed else jax.random.fold_in(root_key, state.step)
            loss, grads = jax.value_and_grad(loss_fn)(state.params, key)
            updates, opt_state = self.optimizer.update(
                grads, state.opt_state, state.params
            )
            params = optax.apply_updates(state.params, updates)
            return InverseState(params, opt_state, state.step + 1), loss

        self._train_step = train_step

    def advance(self, steps: int = 1):
        """Run `steps` Adam steps without waiting for the device; returns the
        last step's loss as a device scalar (fetch it to synchronize)."""
        loss = None
        for _ in range(steps):
            self.state, loss = self._train_step(self.state, self._root_key)
        return loss

    def step(self) -> float:
        return float(self.advance())

    def scene(self) -> SceneArrays:
        return apply_params(self.base_scene, self.state.params)

    def run(self, steps: int, log_every: int = 0) -> list:
        losses = []
        for i in range(steps):
            losses.append(self.step())
            if log_every and (i + 1) % log_every == 0:
                from ..utils.logging import logger

                logger.info("inverse step %d: loss %.3e", i + 1, losses[-1])
        return losses
