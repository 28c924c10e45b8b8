from riggs_tpu_torch.camera.camera import (
    Camera,
    camera_center,
    focal2fov,
    fov2focal,
    make_camera,
    project_nodes_2d,
    project_points,
    world_to_view,
)
