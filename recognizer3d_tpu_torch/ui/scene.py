"""The vispy scene: cloud panels with mask overlays, and a text overlay
(counterpart of ``recognizer3d_tpu/ui/scene.py``).

- a base cloud renders as small red markers, at most 10,000 of them;
- the "annotation" (blue) and "prediction" (green) overlays are boolean
  masks into the full-resolution base cloud, blended additively;
- an arcball camera with fov=0 and a fixed home orientation; the app's
  three panels rotate together (linked cameras);
- a middle-mouse click on the annotatable panel casts a screen ray and
  toggles the nearest point's annotation (``ui/annotation.py``), calling
  back with the new mask.

Each panel draws its display subsample from its own generator, seeded 0,
so the points shown for given clouds are the same in every run.
"""

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import vispy.scene
from vispy.scene import ArcballCamera
from vispy.util.quaternion import Quaternion
from vispy.visuals import TextVisual

from recognizer3d_tpu_torch.ui.annotation import display_subsample, pick_annotation

# overlay name -> marker colour; drawn in insertion order
OVERLAY_COLORS = {"annotation": "blue", "prediction": "green"}
_BASE_COLOR = "red"
_BASE_SIZE = 0.001
_OVERLAY_SIZE = 0.01
_HOME_ORIENTATION = (0.707, 0.707, 0.0, 0.0)  # w, x, y, z
_PLACEHOLDER = np.zeros((1, 3), dtype=np.float32)


class CloudPanel:
    """One viewbox: a full-resolution point cloud and named mask overlays."""

    def __init__(
        self,
        viewbox,
        on_annotation_change: Optional[Callable[[np.ndarray], None]] = None,
        offset=(0.0, 0.0, 0.3),
    ):
        self._viewbox = viewbox
        self._offset = np.asarray(offset, dtype=np.float32)
        self._on_annotation_change = on_annotation_change
        self._rng = np.random.default_rng(0)

        root = vispy.scene.node.Node(name="panel root")
        viewbox.add(root)
        self._base = vispy.scene.Markers(parent=root, scaling=True)
        self._base.set_gl_state("opaque", depth_test=False, cull_face=False)
        self._layers: Dict[str, vispy.scene.Markers] = {}
        self._masks: Dict[str, Optional[np.ndarray]] = {}
        for name in OVERLAY_COLORS:
            layer = vispy.scene.Markers(parent=root, scaling=True)
            layer.set_gl_state("additive")
            self._layers[name] = layer
            self._masks[name] = None
        self._cloud: Optional[np.ndarray] = None

        camera = ArcballCamera(fov=0)
        camera._quaternion = Quaternion(*_HOME_ORIENTATION)
        camera.depth_value = 1.0
        camera.view_changed()
        viewbox.camera = camera

        if on_annotation_change is not None:
            viewbox.events.mouse_press.connect(self._on_mouse_press)

    def _render(self, markers, points, color, size) -> None:
        """Push (a display subsample of) ``points`` into a Markers visual;
        ``None`` hides the visual."""
        shown = display_subsample(points, self._rng)
        markers.set_data(
            pos=_PLACEHOLDER if shown is None else shown,
            edge_width=0.0,
            edge_color=None,
            face_color=color,
            size=size,
        )
        markers.visible = points is not None

    # -- base cloud ----------------------------------------------------

    @property
    def cloud(self) -> Optional[np.ndarray]:
        """Full-resolution cloud as given (without the display offset)."""
        return self._cloud

    def show_cloud(self, xyz: np.ndarray) -> None:
        """Display a new cloud; any previous annotation no longer applies."""
        self._cloud = xyz
        self._render(self._base, xyz - self._offset, _BASE_COLOR, _BASE_SIZE)
        self.set_overlay("annotation", None)

    # -- overlays ------------------------------------------------------

    def get_overlay(self, name: str) -> Optional[np.ndarray]:
        return self._masks[name]

    def set_overlay(self, name: str, mask: Optional[np.ndarray]) -> None:
        """Show the points selected by a boolean ``mask`` over the base
        cloud (``None`` clears the overlay)."""
        self._masks[name] = mask
        selected = None
        if mask is not None and self._cloud is not None:
            selected = (self._cloud - self._offset)[mask.astype(bool)]
        self._render(self._layers[name], selected, OVERLAY_COLORS[name], _OVERLAY_SIZE)

    # -- annotation picking --------------------------------------------

    def _on_mouse_press(self, event) -> None:
        if event.button != 3:  # middle mouse only
            return
        if self._cloud is None or len(self._cloud) == 0:
            print("No data captured yet.")
            return
        # two screen points one unit apart in depth -> a world-space ray
        to_world = self._viewbox.scene.transform.imap
        near = to_world(event.pos)
        far = to_world(event.pos + np.array([0, 0, 1, 0]))
        if abs(near[3] - 1.0) >= 1e-5 or abs(far[3] - 1.0) >= 1e-5:
            raise RuntimeError(f"the click ray is not affine: w = {near[3]}, {far[3]}")
        _, mask = pick_annotation(
            near[:3], far[:3], self._cloud - self._offset, self.get_overlay("annotation")
        )
        self.set_overlay("annotation", mask)
        if self._on_annotation_change is not None:
            self._on_annotation_change(mask)


class TextOverlay(vispy.scene.Widget):
    """A text widget pinned to its layout cell's lower-left corner (the
    predict CLI's help overlay)."""

    def __init__(self, text: str, **text_kwargs) -> None:
        self._visual = TextVisual(text=text, **text_kwargs)
        super().__init__()
        self.add_subvisual(self._visual)
        self._reposition()

    def on_resize(self, event) -> None:
        self._reposition()

    def _reposition(self) -> None:
        self._visual.pos = (self.rect.left + 4, 4)

    @property
    def text(self) -> str:
        return self._visual.text

    @text.setter
    def text(self, value: str) -> None:
        self._visual.text = value


@dataclass
class Triptych:
    """The app's three linked panels on one canvas."""

    canvas: "vispy.scene.SceneCanvas"
    live: CloudPanel
    captured: CloudPanel
    prediction: CloudPanel


def build_triptych(tk_parent, on_annotation_change: Callable[[np.ndarray], None]) -> Triptych:
    """The live, captured (annotatable) and prediction panels inside a Tk
    container, their cameras linked so that rotating one rotates all."""
    canvas = vispy.scene.SceneCanvas(
        title="visualization 3D",
        keys="interactive",
        show=True,
        fullscreen=False,
        size=(200, 600),
        position=(0, 0),
        parent=tk_parent,
    )
    grid = canvas.central_widget.add_grid()

    def cell(col):
        return grid.add_view(border_color=(0.5, 0.5, 0.5, 1), row=0, col=col)

    no_offset = (0.0, 0.0, 0.0)
    panels = Triptych(
        canvas=canvas,
        live=CloudPanel(cell(0), offset=no_offset),
        captured=CloudPanel(cell(1), on_annotation_change=on_annotation_change, offset=no_offset),
        prediction=CloudPanel(cell(2), offset=no_offset),
    )
    panels.live._viewbox.camera.link(panels.captured._viewbox.camera)
    panels.live._viewbox.camera.link(panels.prediction._viewbox.camera)
    return panels
