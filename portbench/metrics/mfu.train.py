"""Model FLOPs of the traced epoch over its wall time, as a share (%) of the
H100's float32 peak: a step counts three forwards of its batch
(``counts/model_flops.py``), a validation cloud one."""

from portbench.readers import train_mfu_pct as read  # noqa: F401
