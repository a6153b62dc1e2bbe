"""Model configuration (counterpart of ``recognizer3d_tpu/models/settings.py``).

The same dataclass, field defaults and validation as the JAX package, so a
``config`` JSON from either package's archives builds the same settings.

``knn`` names the neighbour search:

* ``naive``  — exact search. In this package every exact self-KNN runs
  through the hand-written KNN kernel (``ops/knn_kernels.py``) and the
  full-cloud 1-NN upsample through the streaming argmin kernel; on a CPU
  tensor both use their plain PyTorch versions.
* ``pallas`` — the same exact kernels (the JAX package's name for its
  kernel route).
* ``approximate`` — the default, as in the JAX package. Routed as there:
  above 12,288 points (and a distance matrix over 64M entries) the
  Morton-window search, on the window kernel; below, the exact KNN kernel;
  1-NN upsamplings onto supports of up to 32,768 points, the exact route.
  Where the TPU selects with ``approx_min_k`` at a recall target below 1,
  the card selects exactly within the same candidates. The session recall
  guard widens the window or falls back to the exact route as in the JAX
  package (``ops/knn.ensure_window_recall``).
* ``kdtree`` — the host C++ KD-tree (``ops/knn_cpp.py``), as in the JAX
  package.
"""

from dataclasses import dataclass, field
from typing import List

VALID_KNN = ("kdtree", "approximate", "naive", "pallas")
VALID_UPSAMPLING = ("none", "nni", "nna", "idw", "isdw")
VALID_COMPUTE_DTYPE = ("float32", "bfloat16")


@dataclass
class RandLANetSettings:
    #: Number of classes (including background)
    n_classes: int
    #: Number of points used during training
    n_points: int = 10000
    #: Number of point features (excluding xyz coordinates)
    n_features: int = 0
    #: Number of neighbors to observe during local aggregation.
    n_neighbors: int = 32
    #: Downsampling factor for each encoder layer.
    decimation: int = 4
    #: Output sizes of each layer in decoder ("d_out" from the paper, half size)
    layer_sizes: List[int] = field(default_factory=lambda: [16, 64, 128, 256])
    #: KNN approach: "kdtree" | "approximate" | "naive" | "pallas"
    knn: str = "approximate"
    #: Upsampling approach for postprocessing: "none"|"nni"|"nna"|"idw"|"isdw"
    upsampling: str = "nni"
    #: Activation dtype of the dense/attention chain: "float32" or
    #: "bfloat16" (parameters, BatchNorm statistics and geometry stay
    #: float32, in serving and in training).
    compute_dtype: str = "float32"

    def __post_init__(self):
        assert self.knn in VALID_KNN, (
            f'knn value "{self.knn}" not understood, '
            f"should be one of {VALID_KNN}"
        )
        assert self.compute_dtype in VALID_COMPUTE_DTYPE, (
            f'compute_dtype "{self.compute_dtype}" not understood, '
            f"should be one of {VALID_COMPUTE_DTYPE}"
        )
        assert self.upsampling in VALID_UPSAMPLING, (
            f'upsampling value "{self.upsampling}" not understood, '
            f"should be one of {VALID_UPSAMPLING}"
        )

    def update(self, **kwargs):
        for k, v in kwargs.items():
            if hasattr(self, k):
                setattr(self, k, v)

    @property
    def n_layers(self) -> int:
        return len(self.layer_sizes)

    @property
    def min_n_points(self) -> int:
        """Minimum number of points required by the decimation hierarchy:
        (1) at least K points must remain for the deepest KNN;
        (2) the fully decimated cloud must keep >= 2 points.
        """
        return max(
            self.n_neighbors * (self.decimation ** (self.n_layers - 1)),
            2 * (self.decimation ** self.n_layers),
        )
