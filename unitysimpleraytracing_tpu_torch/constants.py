"""Single-sourced framework configuration (PyTorch port).

Same semantic values as ``unitysimpleraytracing_tpu/constants.py``; the port
keeps its own copy so that it never imports the JAX package.  Build arrays
are padded to a multiple of ``VREG`` so that every array of the port has the
same shape as its JAX counterpart and can be compared bit for bit.
"""

# Pad multiple of the scene arrays.  On the GPU nothing needs this tile; it is
# kept so build arrays stay shape-identical with the JAX package.
SUBLANE = 8
LANE = 128
VREG = SUBLANE * LANE  # 1024

# Radix sort configuration (reference: Constants.cs:8-9 — RADIX=8, BUCKET_SIZE=256).
RADIX_BITS = 8
NUM_BUCKETS = 1 << RADIX_BITS
KEY_BITS = 32
NUM_PASSES = KEY_BITS // RADIX_BITS  # 4 digit passes (ComputeBufferSorter.cs:102)
SORT_BLOCK = 4096

# Traversal (reference: Raytracing.compute:133 — uint stack[64]).
TRAVERSAL_STACK_DEPTH = 64

# Sentinels (reference: SceneDataTypes.cs:63-71 null nodes = 0xFFFFFFFF;
# MeshBufferContainer.cs:108-109 padding keys = uint.MaxValue).
NULL_INDEX = -1
KEY_PADDING = 0xFFFFFFFF  # padding Morton keys sort to the tail

# HLSL MAX_FLOAT = 0x7F7FFFFF (Constants.cginc:7) == float32 max.
MAX_FLOAT = 3.4028234663852886e38

# Fixed scene bound used by the reference to normalize centroids before Morton
# encoding (MeshBufferContainer.cs:9-15: ±125 world units).
PARITY_SCENE_BOUND = 125.0

# AABB inflation applied per-triangle (MeshBufferContainer.cs:55-63).
AABB_INFLATION = 1e-3

# Morton grid resolution: 10 bits per axis, 30-bit codes
# (MeshBufferContainer.cs:41-50).
MORTON_BITS_PER_AXIS = 10
MORTON_GRID = 1 << MORTON_BITS_PER_AXIS  # 1024


def pad_count(n: int, multiple: int = VREG) -> int:
    """Round ``n`` up to a multiple of ``multiple`` (at least one full tile)."""
    if n <= 0:
        raise ValueError(f"need at least one element, got {n}")
    return max(((n + multiple - 1) // multiple) * multiple, multiple)
