"""The interactive capture, annotate, train and predict app of the port
(counterpart of the repository's ``main.py``)::

    python -m recognizer3d_tpu_torch.app [--device cuda|cpu]

A Tk window holding the three vispy panels (live, captured and
annotatable, prediction) over a control bar. A 34 ms camera poll refreshes
the live panel and, while Predict is toggled on, predicts every 250 ms:
with ``LivePredictor`` on the camera's raw depth frames where the camera
has depth intrinsics, else with ``Predictor`` on its clouds. Capture writes
the current cloud into ``data/<name>`` in the on-disk dataset format;
every annotation click is stored at once; Train runs the app's recipe in a
background process with a progress bar; Escape kills any training job,
stops the camera and exits. Camera and prediction errors other than "No
valid frame received." are printed and the loop goes on. Models and data
live under the working directory. The models run on the GPU unless
``--device cpu`` is given; without a GPU the app raises.
"""

import sys
import tkinter as tk
from datetime import datetime
from pathlib import Path
from time import monotonic
from traceback import print_exc
from typing import Optional

import vispy

from recognizer3d_tpu_torch.camera import auto_connect_camera
from recognizer3d_tpu_torch.data.dataset import Dataset
from recognizer3d_tpu_torch.models.facade import Model
from recognizer3d_tpu_torch.models.live import LivePredictor
from recognizer3d_tpu_torch.predict import Predictor
from recognizer3d_tpu_torch.train import MODELS_DIR, TrainingJob
from recognizer3d_tpu_torch.ui.controls import AppActions, ControlBar
from recognizer3d_tpu_torch.ui.scene import build_triptych
from recognizer3d_tpu_torch.utils.device import resolve_device

vispy.use("tkinter")

DATA_DIR = Path("data")
POLL_MS = 34  # ~29 fps live view
PREDICT_EVERY_S = 0.250


class App:
    """Owns the window, the camera, and the predict and train lifecycles."""

    def __init__(self, window: tk.Tk, device="cuda"):
        self.device = resolve_device(device)
        MODELS_DIR.mkdir(parents=True, exist_ok=True)
        self.window = window
        window.title("3D gesture capturing")

        self._predictor: Optional[Predictor] = None
        self._live_predictor: Optional[LivePredictor] = None
        self._next_prediction_due = monotonic()
        self._capture_timestamp = datetime.now()

        frame = tk.Frame()
        self.scene = build_triptych(frame, self._annotation_changed)
        self.scene.canvas.native.pack(side=tk.TOP, anchor="nw", fill=tk.BOTH, expand=True)
        # ControlBar's constructor counts the samples through _dataset(),
        # before the assignment below lands: _dataset() reads None as ""
        self.controls: Optional[ControlBar] = None
        self.controls = ControlBar(
            frame,
            AppActions(
                capture=self._capture,
                count_samples=lambda: len(self._dataset()),
                start_training=self._start_training,
                toggle_predict=self._toggle_predict,
                set_confidence=self._set_confidence,
            ),
            MODELS_DIR,
        )
        self.controls.pack(side=tk.BOTTOM)
        frame.pack(fill=tk.BOTH, expand=True)

        self.camera = auto_connect_camera()
        self.camera.start()

        window.bind("<Escape>", self._quit)
        window.after(POLL_MS, self._tick)

    # -- the poll loop -------------------------------------------------

    def _tick(self) -> None:
        try:
            cloud = self.camera.get()
            self.scene.live.show_cloud(cloud)
            predicting = self._predictor is not None or self._live_predictor is not None
            if predicting and monotonic() >= self._next_prediction_due:
                depth = self.camera.last_depth
                if self._live_predictor is not None and depth is not None:
                    shown, mask = self._live_predictor.predict_depth(depth)
                else:
                    shown, mask = cloud, self._predictor.predict(cloud)
                self.scene.prediction.show_cloud(shown)
                self.scene.prediction.set_overlay("prediction", mask)
                self._next_prediction_due = monotonic() + PREDICT_EVERY_S
        except Exception as error:  # noqa: BLE001 — the poll loop must keep running
            # bad frames are expected; anything else is printed and the
            # loop keeps polling
            if str(error) != "No valid frame received.":
                print_exc()
        self.window.after(POLL_MS, self._tick)

    # -- capture and annotation ----------------------------------------

    def _dataset(self) -> Dataset:
        name = "" if self.controls is None else self.controls.dataset_name
        return Dataset(DATA_DIR / name)

    def _capture(self) -> None:
        cloud = self.camera.last_cloud
        self._capture_timestamp = datetime.now()
        self.scene.captured.show_cloud(cloud)
        self._dataset()[self._capture_timestamp] = cloud

    def _annotation_changed(self, mask) -> None:
        self._dataset().set_annotation(self._capture_timestamp, mask)

    # -- training ------------------------------------------------------

    def _start_training(self) -> TrainingJob:
        return TrainingJob.launch([DATA_DIR / self.controls.dataset_name], device=str(self.device))

    # -- prediction ----------------------------------------------------

    def _toggle_predict(self, enable: bool) -> bool:
        if not enable:
            self._predictor = None
            self._live_predictor = None
            return True
        model_name = self.controls.model_name
        if model_name == "":
            print("No model loaded yet. First train a model.")
            return False
        intrinsics = self.camera.depth_intrinsics
        if intrinsics is not None:
            # the camera gives raw depth: the live depth path, with the
            # camera's own calibration
            self._live_predictor = LivePredictor(
                Model.load(MODELS_DIR / model_name, device=self.device),
                self.controls.confidence,
                intrinsics=intrinsics,
            )
        else:
            self._predictor = Predictor(
                MODELS_DIR / model_name,
                self.controls.confidence,
                # warm the padded-size bucket the live frames land in (empty
                # before the first frame: Predictor's 30-point minimum)
                warmup_points=self.camera.last_cloud.shape[0],
                device=self.device,
            )
        return True

    def _set_confidence(self, value: float) -> None:
        if self._predictor is not None:
            self._predictor.confidence_threshold = value
        if self._live_predictor is not None:
            self._live_predictor.confidence_threshold = value

    # -- shutdown ------------------------------------------------------

    def _quit(self, _event) -> None:
        job = self.controls.training_job
        if job is not None:
            job.kill()
        self.camera.stop()
        self.window.withdraw()
        sys.exit()


def main(argv=None) -> None:
    from argparse import ArgumentParser

    parser = ArgumentParser(
        "App", usage="python -m recognizer3d_tpu_torch.app [--device cuda|cpu]",
        description="Capture, annotate, train and predict in one window.",
    )
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Where the models run (default: the GPU).")
    args = parser.parse_args(argv)
    root = tk.Tk()
    App(root, device=args.device)
    root.mainloop()


if __name__ == "__main__":
    main()
