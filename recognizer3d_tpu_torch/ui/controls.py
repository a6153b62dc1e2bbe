"""The app's Tk control bar: capture, train and predict in one widget
(counterpart of ``recognizer3d_tpu/ui/controls.py``).

- a dataset-name entry whose sample counter refreshes on every keystroke,
  and a Capture button;
- a Train button with a determinate progress bar polled every 500 ms while
  a training job runs, and a label naming the newest model (the last entry
  of the models directory by name: timestamps sort chronologically);
- a Predict toggle (sunken while active) and a 0–1 confidence slider in
  steps of 0.01, starting at 0.5.

One widget with three columns, wired to an :class:`AppActions` bundle of
callbacks at construction.
"""

import tkinter as tk
from dataclasses import dataclass
from pathlib import Path
from tkinter import ttk
from typing import Callable

_POLL_MS = 500


@dataclass
class AppActions:
    """Everything the control bar can ask the application to do."""

    capture: Callable[[], None]
    count_samples: Callable[[], int]
    start_training: Callable[[], object]  # returns a job with .poll() -> int
    toggle_predict: Callable[[bool], bool]  # returns whether it was accepted
    set_confidence: Callable[[float], None]


class ControlBar(tk.Frame):
    def __init__(self, master, actions: AppActions, models_dir: Path):
        super().__init__(master)
        self._actions = actions
        self._models_dir = models_dir
        self._job = None

        self._build_capture_column().pack(side=tk.LEFT)
        self._build_train_column().pack(side=tk.LEFT)
        self._build_predict_column().pack(side=tk.RIGHT)
        self.refresh_sample_count()
        self.refresh_model_name()

    # -- capture -------------------------------------------------------

    def _build_capture_column(self) -> tk.Frame:
        column = tk.Frame(self)
        tk.Label(column, anchor="e", text="Dataset name:").grid(row=0, column=0)
        self._dataset_entry = tk.Entry(column)
        self._dataset_entry.bind("<KeyRelease>", self.refresh_sample_count)
        self._dataset_entry.grid(row=0, column=1, sticky=tk.EW)
        tk.Button(column, anchor="e", text="Capture", command=self._on_capture).grid(
            row=1, column=0, columnspan=2, sticky=tk.EW
        )
        self._sample_count = tk.Label(column)
        self._sample_count.grid(row=2, column=0, columnspan=2)
        return column

    @property
    def dataset_name(self) -> str:
        return self._dataset_entry.get()

    def _on_capture(self) -> None:
        self._actions.capture()
        self.refresh_sample_count()

    def refresh_sample_count(self, *_event) -> None:
        self._sample_count["text"] = self._actions.count_samples()

    # -- training ------------------------------------------------------

    def _build_train_column(self) -> tk.Frame:
        column = tk.Frame(self)
        self._train_button = tk.Button(column, anchor="e", text="Train", command=self._on_train)
        self._train_button.grid(row=0, column=0, columnspan=2)
        self._progress = ttk.Progressbar(
            column, orient=tk.HORIZONTAL, length=100, mode="determinate"
        )
        self._progress.grid(row=1, column=0, columnspan=2)
        tk.Label(column, anchor="e", text="Model: ").grid(row=2, column=0)
        self._model_label = tk.Label(column, anchor="e", text="")
        self._model_label.grid(row=2, column=1)
        return column

    @property
    def model_name(self) -> str:
        """Name of the newest trained model ("" if there is none yet)."""
        return self._model_label["text"]

    @property
    def training_job(self):
        """The running training job, if any (the app kills it on exit)."""
        return self._job

    def refresh_model_name(self) -> None:
        if not self._models_dir.is_dir():  # nothing trained yet
            return
        entries = sorted(self._models_dir.iterdir())
        if entries:
            self._model_label["text"] = entries[-1].name

    def _on_train(self) -> None:
        self._train_button["state"] = "disabled"
        self._progress["value"] = 1
        self._job = self._actions.start_training()
        self.after(_POLL_MS, self._poll_training)

    def _poll_training(self) -> None:
        if self._job is None:
            return
        percent = self._job.poll()
        self._progress["value"] = percent
        if percent < 100:
            self.after(_POLL_MS, self._poll_training)
            return
        self._job = None
        self._train_button["state"] = "normal"
        self.refresh_model_name()

    # -- prediction ----------------------------------------------------

    def _build_predict_column(self) -> tk.Frame:
        column = tk.Frame(self)
        tk.Label(column, text="Confidence").pack()
        self._confidence = tk.Scale(
            column,
            from_=0,
            to=1,
            resolution=0.01,
            command=lambda v: self._actions.set_confidence(float(v)),
        )
        self._confidence.set(0.5)
        self._confidence.pack()
        self._predict_button = tk.Button(column, anchor="e", text="Predict",
                                         command=self._on_predict)
        self._predict_button.pack(side=tk.BOTTOM)
        return column

    @property
    def confidence(self) -> float:
        return float(self._confidence.get())

    def _predicting(self) -> bool:
        return self._predict_button.config("relief")[-1] == "sunken"

    def _on_predict(self) -> None:
        enable = not self._predicting()
        if self._actions.toggle_predict(enable):
            self._predict_button.config(relief="sunken" if enable else "raised")
