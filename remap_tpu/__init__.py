"""remap_tpu — a JAX (XLA/Pallas) game-world-map reconstruction framework
for the GPU.

Re-designed from scratch with the capabilities of the C++/AVX2 reference
``kataklinger/remap``: decoded gameplay frames stream through batched device
kernels for grid keypoint extraction, offset-vote matching, foreground
detection and atlas stitching, producing one world-map image per connected
map fragment.

Layering (bottom → top):

- ``core``      palette tables, geometry, region-band layout
- ``io``        raw-frame feeds, nibble/RLE codecs, PNG writer, checkpoints
- ``spec``      pure-NumPy executable specification (the bit-exactness oracle)
- ``ops``       JAX/Pallas device kernels (median/keypoints/matching/atlas/…)
- ``pipeline``  the five stages (window → collect → splice → filter → clean)
  and the orchestrating builder
- ``parallel``  device meshes, sharded batch pipelines, multi-device dry runs
- ``utils``     profiling, synthetic-clip generation, compile cache,
  backend choices

The compute path is pure JAX (jit/vmap/lax.scan + Pallas kernels); host-side
orchestration is Python with optional C++ acceleration for the frame codec.
"""

__version__ = "0.1.0"

from remap_tpu.config import PipelineConfig  # noqa: F401
