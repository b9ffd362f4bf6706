"""Training listeners (counterpart of
``deeplearning4j_tpu/optimize/listeners.py``; reference
``optimize/api/TrainingListener.java`` and ``optimize/listeners/``).

``fit`` calls ``iteration_done(model, iteration, epoch)`` after every
updater step and ``on_epoch_start`` / ``on_epoch_end`` around every epoch
(``nn/training.py``); any object with those methods is a listener, these
are the library's.

- :class:`ScoreIterationListener`, :class:`PerformanceListener`
  (samples/s, batches/s), :class:`CollectScoresIterationListener`,
  :class:`TimeIterationListener`, :class:`EvaluativeListener` (over the
  port's ``eval/``) and :class:`SleepyTrainingListener`, as the JAX
  package's. Reading ``model.score()`` waits for the step's loss on the
  card.
- :class:`ProfilerListener` records a window of iterations with
  ``torch.profiler`` and writes a Chrome trace (``trace.json``) into
  ``log_dir``; it synchronizes the card before it stops, so the window
  holds the device work and not only its launches.
- :class:`CheckpointListener` saves every N iterations or epochs through
  ``utils/serialization.write_model`` with bounded retention; its zips are
  the JAX package's format, read by either package's ``restore``.
- :class:`ConvolutionalIterationListener` tiles each convolutional
  activation of the last batch's first example into a grayscale PNG and
  stores the JAX package's update record (type id ``ActivationsListener``)
  into any object with ``put_update``. Without Pillow it is disabled, as
  in the JAX package.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

log = logging.getLogger(__name__)

# the UI's activations module type id (deeplearning4j_tpu/ui/server.py)
ACTIVATIONS_TYPE_ID = "ActivationsListener"


class TrainingListener:
    """Hook interface (reference TrainingListener.java)."""

    def iteration_done(self, model, iteration: int, epoch: int):
        pass

    def on_epoch_start(self, model):
        pass

    def on_epoch_end(self, model):
        pass

    def on_forward_pass(self, model, activations):
        pass

    def on_gradient_calculation(self, model):
        pass


class ScoreIterationListener(TrainingListener):
    """Log the score every N iterations (reference ScoreIterationListener)."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, print_iterations)

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.print_iterations == 0:
            log.info("Score at iteration %d is %s", iteration, model.score())


class PerformanceListener(TrainingListener):
    """Throughput (reference PerformanceListener.java:19-23): samples/s,
    batches/s over the host clock between reporting iterations."""

    def __init__(self, frequency: int = 1, report_score: bool = False):
        self.frequency = max(1, frequency)
        self.report_score = report_score
        self._last_time: Optional[float] = None
        self.samples_per_sec: Optional[float] = None
        self.batches_per_sec: Optional[float] = None

    def iteration_done(self, model, iteration, epoch):
        now = time.perf_counter()
        if self._last_time is not None and iteration % self.frequency == 0:
            dt = max(now - self._last_time, 1e-9)
            batch = getattr(model, "last_batch_size", None)
            self.batches_per_sec = self.frequency / dt
            if batch:
                self.samples_per_sec = batch * self.frequency / dt
            msg = (f"iteration {iteration}: {self.batches_per_sec:.1f} batches/sec"
                   + (f", {self.samples_per_sec:.1f} samples/sec" if batch else ""))
            if self.report_score:
                msg += f", score {model.score()}"
            log.info(msg)
        if iteration % self.frequency == 0:
            self._last_time = now


class CollectScoresIterationListener(TrainingListener):
    """Collect (iteration, score) pairs (reference
    CollectScoresIterationListener)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, frequency)
        self.scores: List[Tuple[int, float]] = []

    def iteration_done(self, model, iteration, epoch):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(model.score())))


class TimeIterationListener(TrainingListener):
    """Remaining-time logging (reference TimeIterationListener)."""

    def __init__(self, iteration_count: int):
        self.iteration_count = iteration_count
        self.start = time.perf_counter()

    def iteration_done(self, model, iteration, epoch):
        elapsed = time.perf_counter() - self.start
        done = iteration + 1
        remaining = (self.iteration_count - done) * elapsed / max(done, 1)
        log.info("Remaining time: %d min %d sec", int(remaining // 60), int(remaining % 60))


class EvaluativeListener(TrainingListener):
    """Evaluate on a held-out iterator during training (reference
    EvaluativeListener.java:61: a frequency and ITERATION_END /
    EPOCH_END). ``evaluations`` are zero-argument factories (e.g.
    ``Evaluation``), so each invocation starts fresh; results go to
    ``history`` and to ``callback(model, evals)``."""

    ITERATION_END = "iteration_end"
    EPOCH_END = "epoch_end"

    def __init__(self, iterator, frequency: int = 1, invocation_type: str = EPOCH_END,
                 evaluations=None, callback=None):
        self.iterator = iterator
        self.frequency = max(1, frequency)
        self.invocation_type = invocation_type
        self.evaluations = evaluations or []
        self.callback = callback
        self.history: List[list] = []
        self._count = 0

    def _invoke(self, model):
        self._count += 1
        if self._count % self.frequency != 0:
            return
        if hasattr(self.iterator, "reset"):
            self.iterator.reset()
        if self.evaluations:
            evals = [f() for f in self.evaluations]
            for ds in self.iterator:
                preds = model.output(ds.features,
                                     features_mask=getattr(ds, "features_mask", None))
                for e in evals:
                    e.eval(ds.labels, preds, mask=getattr(ds, "labels_mask", None))
        else:
            evals = [model.evaluate(self.iterator)]
        self.history.append(evals)
        for e in evals:
            if hasattr(e, "accuracy"):
                log.info("EvaluativeListener: accuracy %.4f", e.accuracy())
        if self.callback is not None:
            self.callback(model, evals)

    def iteration_done(self, model, iteration, epoch):
        if self.invocation_type == self.ITERATION_END:
            self._invoke(model)

    def on_epoch_end(self, model):
        if self.invocation_type == self.EPOCH_END:
            self._invoke(model)


class SleepyTrainingListener(TrainingListener):
    """Debug throttling (reference SleepyTrainingListener)."""

    def __init__(self, sleep_ms: int = 0):
        self.sleep_ms = sleep_ms

    def iteration_done(self, model, iteration, epoch):
        if self.sleep_ms:
            time.sleep(self.sleep_ms / 1000.0)


def _sync(model):
    device = getattr(model, "device", None) if model is not None else None
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class ProfilerListener(TrainingListener):
    """Record iterations [start_iteration, start_iteration +
    num_iterations) with ``torch.profiler`` (host and, on a card, device
    activity) and write a Chrome trace, ``log_dir/trace.json``, readable in
    Perfetto or chrome://tracing."""

    def __init__(self, log_dir: str, start_iteration: int = 10, num_iterations: int = 5):
        self.log_dir = log_dir
        self.start_iteration = start_iteration
        self.num_iterations = num_iterations
        self._prof = None
        self._stop_at = None
        self.completed = False
        self.trace_path: Optional[str] = None

    def iteration_done(self, model, iteration, epoch):
        if self.completed:
            return
        if self._prof is None and iteration >= self.start_iteration:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if getattr(model, "device", torch.device("cpu")).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            _sync(model)
            self._prof = profile(activities=acts)
            self._prof.start()
            self._stop_at = iteration + self.num_iterations
            return
        if self._prof is not None and iteration >= self._stop_at:
            self.close(model)

    def close(self, model=None):
        """Stop and write a window left open because training ended inside
        it (epoch boundaries do not stop it: a window may span epochs)."""
        if self._prof is None:
            return
        _sync(model)  # the window holds the device work, not only launches
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(self.log_dir, "trace.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        self.completed = True
        log.info("Profiler trace written to %s", self.trace_path)


class CheckpointListener(TrainingListener):
    """Checkpoint every N iterations or epochs with bounded retention
    (reference CheckpointListener): ``utils/serialization.write_model``
    zips, which carry parameters, updater state and the iteration / epoch
    counters, so a restored network continues where it stopped.
    ``checkpoint.CheckpointManager`` (``fit(checkpoint_manager=)``) writes
    off the step loop, atomically, with exact-step resume; this listener
    is the simple save-every-N form."""

    def __init__(self, checkpoint_dir: str, every_n_iterations: int = 0,
                 every_n_epochs: int = 0, keep_last: int = 3, save_updater: bool = True):
        if not every_n_iterations and not every_n_epochs:
            raise ValueError("Set every_n_iterations or every_n_epochs")
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.checkpoint_dir = checkpoint_dir
        self.every_n_iterations = every_n_iterations
        self.every_n_epochs = every_n_epochs
        self.keep_last = keep_last
        self.save_updater = save_updater
        # adopt earlier runs' checkpoints, so keep_last bounds the disk
        # across restore_last resume cycles too
        self.saved_paths: List[str] = sorted(
            (os.path.join(checkpoint_dir, f) for f in os.listdir(checkpoint_dir)
             if f.startswith("checkpoint_") and f.endswith(".zip")),
            key=os.path.getmtime)

    def _save(self, model, tag: str):
        from deeplearning4j_tpu_torch.utils.serialization import write_model
        path = os.path.join(self.checkpoint_dir, f"checkpoint_{tag}.zip")
        write_model(model, path, save_updater=self.save_updater)
        if path in self.saved_paths:
            self.saved_paths.remove(path)
        self.saved_paths.append(path)
        while len(self.saved_paths) > self.keep_last:
            old = self.saved_paths.pop(0)
            try:
                os.remove(old)
            except OSError:
                pass

    def iteration_done(self, model, iteration, epoch):
        if self.every_n_iterations and iteration > 0 \
                and iteration % self.every_n_iterations == 0:
            self._save(model, f"iter_{iteration}")

    def on_epoch_end(self, model):
        if self.every_n_epochs and (model.epoch + 1) % self.every_n_epochs == 0:
            self._save(model, f"epoch_{model.epoch}")

    @staticmethod
    def last_checkpoint(checkpoint_dir: str) -> Optional[str]:
        """The most recent checkpoint in a directory, or None."""
        files = [os.path.join(checkpoint_dir, f) for f in os.listdir(checkpoint_dir)
                 if f.startswith("checkpoint_") and f.endswith(".zip")]
        return max(files, key=os.path.getmtime) if files else None

    @staticmethod
    def restore_last(checkpoint_dir: str, device=None):
        """The most recent checkpoint, restored on ``device`` (``cuda``
        unless the caller passes ``device="cpu"``). Raises if there is
        none."""
        from deeplearning4j_tpu_torch.utils.serialization import restore
        path = CheckpointListener.last_checkpoint(checkpoint_dir)
        if path is None:
            raise FileNotFoundError(f"No checkpoints in {checkpoint_dir}")
        return restore(path, device=device)


class ConvolutionalIterationListener(TrainingListener):
    """Convolutional activation grids for the UI's activations module
    (reference ConvolutionIterationListener feeding
    ConvolutionalListenerModule). Every ``frequency`` iterations the first
    example of the last fit batch (``model._last_features``) runs forward,
    each 4-D activation's channels are tiled into one grayscale grid, and a
    base64 PNG update record is stored in ``storage``. ``needs_features``
    asks ``fit`` to keep that example, which it does only for a listener
    that sets it."""

    needs_features = True

    def __init__(self, storage, frequency: int = 10, session_id: Optional[str] = None,
                 max_layers: int = 4, max_channels: int = 64):
        import socket
        import uuid
        try:
            import PIL  # noqa: F401
            self._png_ok = True
        except ImportError:
            log.warning("Pillow not available: ConvolutionalIterationListener "
                        "disabled (no PNG encoder)")
            self._png_ok = False
        self.storage = storage
        self.frequency = max(1, int(frequency))
        self.session_id = session_id or str(uuid.uuid4())
        self.worker_id = socket.gethostname()
        self.max_layers = max_layers
        self.max_channels = max_channels

    @staticmethod
    def _tile_png(act) -> str:
        """(H, W, C) activation -> tiled grayscale grid PNG (base64)."""
        import base64
        import io

        from PIL import Image
        a = np.asarray(act, np.float32)
        h, w, c = a.shape
        cols = int(np.ceil(np.sqrt(c)))
        rows = int(np.ceil(c / cols))
        grid = np.zeros((rows * (h + 1), cols * (w + 1)), np.float32)
        for i in range(c):
            ch = a[:, :, i]
            lo, hi = float(ch.min()), float(ch.max())
            ch = (ch - lo) / (hi - lo) if hi > lo else np.zeros_like(ch)
            r, col = divmod(i, cols)
            grid[r * (h + 1):r * (h + 1) + h, col * (w + 1):col * (w + 1) + w] = ch
        img = Image.fromarray((grid * 255).astype(np.uint8), mode="L")
        buf = io.BytesIO()
        img.save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    def _conv_activations(self, model):
        """name -> (H, W, C) activation of each 4-D layer output for the
        first example of the last batch."""
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        x = getattr(model, "_last_features", None)
        if x is None:
            return {}

        def host(a):
            return a.detach().float().cpu().numpy()

        out = {}
        if isinstance(model, MultiLayerNetwork):
            acts = model.feed_forward(x[:1])
            for i, (layer, a) in enumerate(zip(model.layers, acts)):
                if a.dim() == 4:
                    out[f"layer{i}_{type(layer).__name__}"] = host(a)[0]
        else:
            feats = [f[:1].to(model.device) for f in (x if isinstance(x, (list, tuple))
                                                      else [x])]
            with torch.no_grad():
                acts = model._forward(model.params, model.state, feats, False)[0]
            for name in model.order:
                if acts[name].dim() == 4:
                    out[name] = host(acts[name])[0]
        return dict(list(out.items())[: self.max_layers])

    def iteration_done(self, model, iteration, epoch):
        if not self._png_ok or iteration % self.frequency != 0:
            return
        layers = {name: self._tile_png(a[:, :, : self.max_channels])
                  for name, a in self._conv_activations(model).items()}
        if not layers:
            return
        self.storage.put_update({
            "kind": "update", "session_id": self.session_id,
            "type_id": ACTIVATIONS_TYPE_ID, "worker_id": self.worker_id,
            "timestamp": int(time.time() * 1000),
            "iteration": int(iteration), "layers": layers,
        })
