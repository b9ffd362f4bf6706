"""The port's offline command-line tools, counterparts of the JAX
package's repo-root ``tools/`` scripts. Each runs as
``python -m deeplearning4j_tpu_torch.tools.<name>`` and exposes
``build_parser()`` (where the JAX tool has one) and ``main(argv)``:

- ``run_lint``: the port's linter (``analysis/lint.py``) over the port;
- ``obs_report``: a post-mortem report of ``obs.EventLog`` /
  ``obs.flight`` outputs;
- ``lake``: ``ls`` / ``get`` / ``put`` / ``gc`` / ``cache-stats`` against
  any ``checkpoint/cloud.backend_from_url`` store;
- ``build_index``: build, gate, save and load a retrieval index;
- ``quantize``: post-training int8 quantization of a checkpoint;
- ``autotune``: the memory planner and the autotuner, writing a
  ``TuningRecord``.

The tools that touch tensors (``build_index``, ``quantize``,
``autotune``) run on ``cuda`` unless given ``--device cpu``, and raise
with no card (``device.py``).
"""
