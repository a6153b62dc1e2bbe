"""``Predictor`` and the prediction CLI of the port (counterpart of the
repository's ``predict.py``).

``Predictor`` loads a model archive, runs one throwaway prediction so the
first real frame does not pay the one-time costs (the kernel build and
load, CUDA context and allocator warm-up), and turns class-1 confidences
into a boolean mask at a threshold. Unlike the JAX package's ``Predictor``,
the throwaway cloud does not feed the session recall guard of
``knn="approximate"``: the guard probes the first real cloud, as both
packages' ``LivePredictor`` does.

The CLI walks the given datasets and shows each sample in a blocking vispy
window (Enter: next, Escape: stop), or prints one line of counts a sample
with ``--no-viz``::

    python -m recognizer3d_tpu_torch.predict -m models/<timestamp> -d data/dataset1 \\
        [-c 0.5] [--no-viz] [--transfer-dtype float16] [--device cuda]

Paths are taken relative to the working directory.
"""

from pathlib import Path

import numpy as np

from recognizer3d_tpu_torch.models.facade import Model


class Predictor:
    """A loaded, warmed-up model producing boolean per-point masks."""

    def __init__(
        self,
        model_path: Path,
        confidence_threshold: float = 0.5,
        transfer_dtype: str = "float16",
        warmup_points: int = 30,
        device="cuda",
    ) -> None:
        """:param transfer_dtype: upload dtype of full clouds; float16 halves
        the host-to-device bytes per frame, and its input quantization
        (~0.3 mm at a 0.6 m range) sits below the sensor's 1-2 mm depth
        noise. Pass "float32" for exact parity runs.
        :param warmup_points: size of the dummy warm-up cloud; pass a
        representative frame size so the warm-up touches the same bucket
        as the real frames.
        :param device: the GPU unless the caller asks for ``"cpu"``."""
        self.confidence_threshold = float(confidence_threshold)
        self._model = Model.load(
            Path(model_path), device=device, transfer_dtype=transfer_dtype
        )
        self._warm_up(max(int(warmup_points), 30))

    @property
    def model(self) -> Model:
        return self._model

    def _warm_up(self, n_points: int) -> None:
        # the random cloud must not feed the recall guard: the guard's
        # window is process-global and only widens, so it probes the first
        # real cloud instead
        model = self._model
        guard_ran, model._recall_guard_ran = model._recall_guard_ran, True
        try:
            model.predict_mask(np.random.random((n_points, 3)), self.confidence_threshold)
        finally:
            model._recall_guard_ran = guard_ran

    def predict(self, point_cloud: np.ndarray) -> np.ndarray:
        """(N,) bool: foreground confidence above the threshold."""
        return self._model.predict_mask(point_cloud, self.confidence_threshold)


_HELP_TEXT = (
    "red: captured data \n"
    "green: prediction from the model \n"
    "blue: annotation \n"
    "white: overlap of all three above \n"
    "Press enter for next sample. Press escape to stop."
)


def visualize(point_cloud: np.ndarray, annotation: np.ndarray, prediction: np.ndarray) -> bool:
    """Show one sample in a blocking vispy window; returns True when the
    user pressed Escape (stop iterating)."""
    import vispy

    try:
        vispy.use("tkinter")
    except RuntimeError:
        pass  # a backend is already in use (e.g. inside the app)
    import vispy.app
    import vispy.scene

    from recognizer3d_tpu_torch.ui.scene import CloudPanel, TextOverlay

    canvas = vispy.scene.SceneCanvas(
        title="visualization 3D",
        keys="interactive",
        show=True,
        fullscreen=False,
        size=(1000, 600),
        position=(0, 0),
    )
    stop_requested = False

    def on_key(event):
        nonlocal stop_requested
        if event.key == vispy.keys.ESCAPE:
            stop_requested = True
            vispy.app.quit()
        elif event.key == vispy.keys.ENTER:
            vispy.app.quit()

    canvas.events.key_press.connect(on_key)

    panel = CloudPanel(canvas.central_widget.add_view())
    panel.show_cloud(point_cloud)
    panel.set_overlay("annotation", annotation)
    panel.set_overlay("prediction", prediction)
    canvas.central_widget.add_widget(
        TextOverlay(_HELP_TEXT, color="white", anchor_x="left", anchor_y="bottom")
    )
    canvas.show(visible=True)
    vispy.app.run()
    return stop_requested


def main(argv=None) -> None:
    from argparse import ArgumentParser

    from recognizer3d_tpu_torch.data.dataset import Dataset, DatasetMerged

    parser = ArgumentParser(
        "Predictor",
        usage="python -m recognizer3d_tpu_torch.predict -m models/<timestamp> -d data/dataset1",
        description="Visualize a model's predictions without the UI: each sample of the "
        "dataset(s) is shown in turn. Press 'enter' for the next sample, 'escape' to stop.",
    )
    parser.add_argument("-m", "--model", required=True, help="The model archive to use.")
    parser.add_argument("-d", "--dataset", nargs="+", required=True,
                        help="One or more datasets to predict.")
    parser.add_argument("-c", "--confidence", required=False, default=0.5, type=float,
                        help="The confidence threshold (default 0.5).")
    parser.add_argument("--no-viz", action="store_true",
                        help="Print each sample's prediction counts instead of showing it.")
    parser.add_argument(
        "--transfer-dtype", choices=("float32", "float16"), default="float16",
        help="Upload dtype of full clouds (default float16: half the host-to-device bytes "
        "a frame, quantization ~0.3 mm at the sensor's range cap). float32 for exact parity.",
    )
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Where the model runs (default: the GPU).")
    args = parser.parse_args(argv)

    samples = DatasetMerged(
        [Dataset(Path(name), only_annotated=False, broaden_annotations=True)
         for name in args.dataset]
    )
    predictor = Predictor(
        Path(args.model),
        args.confidence,
        args.transfer_dtype,
        # warm the bucket the real clouds land in
        warmup_points=samples[0][0].shape[0] if len(samples) else 30,
        device=args.device,
    )
    for point_cloud, _features, annotation in samples:
        prediction = predictor.predict(point_cloud)
        if args.no_viz:
            print(
                f"cloud: {point_cloud.shape[0]} pts, "
                f"predicted positives: {int(prediction.sum())}, "
                f"annotated positives: {int(annotation.sum())}"
            )
        elif visualize(point_cloud, annotation, prediction):
            break


if __name__ == "__main__":
    main()
