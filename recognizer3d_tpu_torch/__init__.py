"""PyTorch/CUDA port of recognizer3d_tpu: RandLA-Net live prediction and
training, with hand-written Hopper kernels for the exact KNN, the 1-NN
upsample and the fused eval LFA. Imports torch and numpy only."""

from recognizer3d_tpu_torch.models.facade import Model
from recognizer3d_tpu_torch.models.settings import RandLANetSettings
from recognizer3d_tpu_torch.predict import Predictor

__all__ = ["Model", "Predictor", "RandLANetSettings"]
