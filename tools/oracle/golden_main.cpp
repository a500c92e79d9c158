// Full-image golden generator.
//
// Drives the reference's ACTUAL renderer (RenderSession, src/Render.cpp) on
// the Cornell scene and leaves its PNG output for the Python suite to
// compare against distributionally (tests/test_golden_image.py). This is
// BASELINE.md's stated correctness bar: our render must match the reference
// CPU output within Monte-Carlo noise.
//
// The scene below is the reference's own cornellBox() scene *data*
// (src/cornelis.cpp:6-74) -- the same data cornelis/scene/library.py
// builds -- fed through the reference's builder API. samplesAA comes from
// argv so the golden's noise floor is a knob (the shipped main hardcodes
// 4096, src/cornelis.cpp:77).
//
// Build & run: tools/oracle/build_golden.sh [spp]

#include <cornelis/Render.hpp>
#include <cornelis/SceneDescription.hpp>

#include <cstdio>
#include <cstdlib>

using namespace cornelis;

static auto cornellBox() -> SceneDescription {
    float sideLen = 555.0f;
    float sideLenHalf = 550.0f / 2.0f;

    SceneDescription d;
    d.setCamera(PerspectiveCameraDescription{.origin = V3(0, sideLenHalf, -1100),
                                             .lookAt = V3(0, sideLenHalf, 0),
                                             .aspect = 1.f,
                                             .horizontalFov = 0.7f});

    auto red = d.addMaterial(MaterialDescription{.albedo = RGB{.65f, .05f, .05f}});
    auto white = d.addMaterial(MaterialDescription{.albedo = RGB{.73f, .73f, .73f}});
    auto green = d.addMaterial(MaterialDescription{.albedo = RGB{.12, .45f, .15f}});
    auto gold = d.addMaterial(MaterialDescription{.albedo = RGB::black(),
                                                  .emissive = RGB::black(),
                                                  .roughness = 0.01f,
                                                  .reflectionTint = RGB(0.916f, 0.61f, 0.0f),
                                                  .ior = 0.470});
    auto light = d.addMaterial(
        MaterialDescription{.albedo = RGB::black(), .emissive = RGB{15, 15, 15}});

    PlaneDescription leftWall{.normal = V3(1.0f, 0, 0),
                              .point = V3(-sideLenHalf, sideLenHalf, 0),
                              .extents = V3(sideLen, sideLen, 0)};
    leftWall.material = green;
    PlaneDescription rightWall{.normal = V3(-1.0f, 0, 0),
                               .point = V3(sideLenHalf, sideLenHalf, 0),
                               .extents = V3(sideLen, sideLen, 0)};
    rightWall.material = red;
    PlaneDescription roof{
        .normal = V3(0, -1.0f, 0), .point = V3(0, sideLen, 0), .extents = V3(sideLen, sideLen, 0)};
    roof.material = white;
    PlaneDescription floor{
        .normal = V3(0, 1.0f, 0), .point = V3(0, 0, 0), .extents = V3(sideLen, sideLen, 0)};
    floor.material = white;
    PlaneDescription backWall{.normal = V3(0, 0, -1.0f),
                              .point = V3(0, sideLenHalf, sideLenHalf),
                              .extents = V3(sideLen, sideLen, 0)};
    backWall.material = white;

    d.addPlane(leftWall);
    d.addPlane(rightWall);
    d.addPlane(roof);
    d.addPlane(floor);
    d.addPlane(backWall);

    SphereDescription lightSphere{.center = V3(0, sideLen - 60.0f, 0), .radius = 60.0f};
    lightSphere.material = light;
    SphereDescription sphere2{.center = V3(0, 50.0f, 0), .radius = 50.0f};
    sphere2.material = red;
    SphereDescription sphere3{.center = V3(-160, 100.0f, 0), .radius = 100.0f};
    sphere3.material = white;
    SphereDescription sphere4{.center = V3(160, 125.0f, 200), .radius = 125.0f};
    sphere4.material = gold;

    d.addSphere(lightSphere);
    d.addSphere(sphere2);
    d.addSphere(sphere3);
    d.addSphere(sphere4);
    return d;
}

int main(int argc, char *argv[]) {
    int spp = argc > 1 ? std::atoi(argv[1]) : 256;
    std::printf("rendering reference cornell 512x512 @ %d spp (seed %u)\n", spp, 19791102u);
    RenderSession session(cornellBox(), RenderOptions{.samplesAA = spp});
    session.render();  // writes ./cornelisrender2.png (src/Render.cpp:263)
    return 0;
}
