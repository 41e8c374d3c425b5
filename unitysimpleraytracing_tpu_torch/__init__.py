"""LBVH raytracing framework — PyTorch/CUDA port for NVIDIA Hopper.

The counterpart of ``unitysimpleraytracing_tpu`` (JAX/Pallas), module for
module: GPU sort → Karras LBVH → BVH4 or binary record tables → per-ray
traversal by a hand-written CUDA kernel → shaded, composited image, one frame
at a time, in batches of frames, or refit per frame for a deforming mesh.  The port imports torch
and numpy only; it never imports the JAX package.  Entry points that create
tensors take ``device=None``, which means the card and raises without one.
"""

from unitysimpleraytracing_tpu_torch import constants
from unitysimpleraytracing_tpu_torch.core.camera import Camera, make_camera, stack_cameras
from unitysimpleraytracing_tpu_torch.core.mesh import (
    MeshData,
    build_scene,
    cube_mesh,
    load_obj,
    subdivide_mesh,
    random_triangle_soup,
    terrain_mesh,
)
from unitysimpleraytracing_tpu_torch.core.texture import (
    Texture,
    load_texture,
    solid_texture,
    texture_from_array,
)
from unitysimpleraytracing_tpu_torch.core.types import Bvh, HitRecord, Scene, Triangles
from unitysimpleraytracing_tpu_torch.pipeline.build import (
    build_bvh,
    deform_scene,
    refit_bvh,
)
from unitysimpleraytracing_tpu_torch.pipeline.render import (
    frame_to_image,
    make_animated_renderer,
    render_frame,
    render_frames,
    render_hits,
    render_rgba,
)

__version__ = "0.1.0"

__all__ = [
    "Bvh",
    "Camera",
    "HitRecord",
    "MeshData",
    "Scene",
    "Texture",
    "Triangles",
    "build_bvh",
    "deform_scene",
    "refit_bvh",
    "build_scene",
    "constants",
    "cube_mesh",
    "frame_to_image",
    "load_obj",
    "subdivide_mesh",
    "load_texture",
    "make_animated_renderer",
    "make_camera",
    "random_triangle_soup",
    "terrain_mesh",
    "render_frame",
    "render_frames",
    "render_hits",
    "render_rgba",
    "solid_texture",
    "stack_cameras",
    "texture_from_array",
]
