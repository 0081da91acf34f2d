"""Training observability: TensorBoard scalars/audio/spectrograms.

A copy of ``bvsc_tpu/utils/logging.py``'s ``TrainLogger``; it touches
neither the device nor a kernel.  Unlike the reference's, it skips the
spectrogram figures where matplotlib is missing.

Same signal set the reference logs (``third_party/BigVGAN/train.py:339-354``
scalars, ``:196-217`` audio + matplotlib spectrogram figures via
``utils.py:15-36``).  Uses torch's TensorBoard writer; degrades to a
no-op where that is missing.
"""

from __future__ import annotations

import numpy as np


class TrainLogger:
    def __init__(self, log_dir: str | None):
        self._sw = None
        if log_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._sw = SummaryWriter(log_dir)
            except Exception:  # pragma: no cover
                self._sw = None

    def scalar(self, tag: str, value, step: int) -> None:
        if self._sw is not None:
            self._sw.add_scalar(tag, float(value), step)

    def scalars(self, values: dict, step: int, prefix: str = "training/") -> None:
        for k, v in values.items():
            self.scalar(prefix + k, np.asarray(v).item(), step)

    def audio(self, tag: str, wav, step: int, sr: int) -> None:
        if self._sw is not None:
            import torch

            self._sw.add_audio(tag, torch.from_numpy(np.asarray(wav).reshape(1, -1)), step, sr)

    def spectrogram_figure(self, tag: str, spec, step: int) -> None:
        """Mel-spectrogram image (reference ``utils.py:15-36``)."""
        if self._sw is None:
            return
        try:
            import matplotlib
        except ImportError:  # figures need matplotlib; scalars and audio log without it
            return

        matplotlib.use("Agg")
        import matplotlib.pylab as plt

        fig, ax = plt.subplots(figsize=(10, 2))
        im = ax.imshow(np.asarray(spec), aspect="auto", origin="lower",
                       interpolation="none")
        plt.colorbar(im, ax=ax)
        fig.canvas.draw()
        self._sw.add_figure(tag, fig, step)
        plt.close(fig)

    def flush(self) -> None:
        if self._sw is not None:
            self._sw.flush()
