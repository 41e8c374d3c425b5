"""LBVH raytracing framework — PyTorch/CUDA port for NVIDIA Hopper.

The counterpart of ``unitysimpleraytracing_tpu`` (JAX/Pallas), module for
module: GPU sort → Karras LBVH → BVH4 or binary record tables → per-ray
traversal by a hand-written CUDA kernel → shaded, composited image, one frame
at a time, in batches of frames, refit per frame for a deforming mesh, or, for
scenes too large for one tree, built and traced in chunks.  The port imports torch
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
from unitysimpleraytracing_tpu_torch.pipeline.chunked import (
    ChunkedBvh,
    build_bvh_chunked,
    occluded_chunked,
    render_frame_chunked,
    render_frames_chunked,
    render_hits_chunked,
    render_rgba_chunked,
    trace_chunked,
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
    "ChunkedBvh",
    "build_bvh",
    "build_bvh_chunked",
    "deform_scene",
    "occluded_chunked",
    "render_frame_chunked",
    "render_frames_chunked",
    "render_hits_chunked",
    "render_rgba_chunked",
    "trace_chunked",
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
