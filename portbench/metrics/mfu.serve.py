"""Model FLOPs (``counts/model_flops.py``) of the traced forwards over the
traced window, as a share (%) of the H100's 67 TFLOP/s float32 peak."""

from portbench.readers import forward_mfu_pct as read  # noqa: F401
