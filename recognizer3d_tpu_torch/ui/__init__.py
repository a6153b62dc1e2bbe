"""UI layer (counterpart of ``recognizer3d_tpu/ui``): the Tk control bar
and the vispy cloud panels.

Imports are lazy (PEP 562), so the package imports on hosts without vispy
or tkinter; only touching a widget needs them. The picking math imports
without either from ``recognizer3d_tpu_torch.ui.annotation``.
"""

_LAZY = {
    "CloudPanel": "recognizer3d_tpu_torch.ui.scene",
    "TextOverlay": "recognizer3d_tpu_torch.ui.scene",
    "Triptych": "recognizer3d_tpu_torch.ui.scene",
    "build_triptych": "recognizer3d_tpu_torch.ui.scene",
    "AppActions": "recognizer3d_tpu_torch.ui.controls",
    "ControlBar": "recognizer3d_tpu_torch.ui.controls",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(name)
