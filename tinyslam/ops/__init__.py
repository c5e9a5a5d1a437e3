"""Device ops: the JAX equivalents of the reference's WGSL shaders.

Reference shader -> op mapping (SURVEY.md §2c ledger):
  grayscale.wgsl        -> ops.image.rgb_to_gray        (fused jnp dot)
  blit.wgsl             -> ops.image.downsample2x       (2x2 average pool)
  gaussian_blur_{x,y}   -> ops.image.gaussian_blur      (correct separable blur;
                           the reference's blur is broken, SURVEY §2a bugs 1-2)
  fast.wgsl             -> ops.fast                     (dense score map, bitwise
                           streak trick on int32 lanes; XLA fuses it)
  atomic compaction     -> ops.compact                  (deterministic top-k + NMS)
  brief.wgsl            -> ops.brief                    (vectorized steered BRIEF)
  (absent in reference) -> ops.hamming                  (int8 matmul Hamming matcher;
                           fused Triton kernel in ops.match_pallas)
"""

from tinyslam.ops.image import (  # noqa: F401
    rgb_to_gray,
    downsample2x,
    gaussian_blur,
    gaussian_kernel,
    build_pyramid,
)
from tinyslam.ops.fast import (  # noqa: F401
    RING16,
    detect_streak,
    detect_streak_16,
    fast_score_map,
)
from tinyslam.ops.compact import select_topk  # noqa: F401
from tinyslam.ops.brief import (  # noqa: F401
    BRIEF_PATTERN,
    brief_descriptors,
    brief_descriptors_binned,
)
from tinyslam.ops.hamming import hamming_distance_matrix, match_descriptors  # noqa: F401
