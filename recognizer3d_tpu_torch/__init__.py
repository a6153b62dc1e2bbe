"""PyTorch/CUDA port of recognizer3d_tpu: RandLA-Net live prediction and
training, with hand-written Hopper kernels for the exact KNN, the 1-NN
upsample and the fused eval LFA, and the app around them. Imports torch and
numpy only.

``Predictor`` is exported lazily (PEP 562), so that ``python -m
recognizer3d_tpu_torch.predict`` runs its module once, as ``__main__``.
"""

from recognizer3d_tpu_torch.models.facade import Model
from recognizer3d_tpu_torch.models.settings import RandLANetSettings

__all__ = ["Model", "Predictor", "RandLANetSettings"]


def __getattr__(name):
    if name == "Predictor":
        from recognizer3d_tpu_torch.predict import Predictor

        return Predictor
    raise AttributeError(name)
