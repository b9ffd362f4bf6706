"""``python -m deeplearning4j_tpu_torch.parallel``: train a saved model with
the data-parallel wrapper (counterpart of the JAX package's ``python -m
deeplearning4j_tpu.parallel``; reference ``ParallelWrapperMain.java:29``).

The same flags. The model zip (either package's) restores through the
port's ``utils/serialization``; the trained model is written back the
same way. ``--dp`` is the data-parallel size (default: every rank of the
``torch.distributed`` group the process runs in, one when there is none);
``--tp`` above 1 trains tensor-parallel over a ``(dp, tp)`` mesh. The
model runs on the card unless ``--device cpu`` is given::

    python -m deeplearning4j_tpu_torch.parallel --model-path m.zip \\
        --data iris --batch 48 --epochs 5 --device cpu
"""

from __future__ import annotations

import argparse
import json


def build_iterator(spec: str, batch: int):
    from deeplearning4j_tpu_torch.datasets import (CifarDataSetIterator, CSVRecordReader,
                                                   IrisDataSetIterator, MnistDataSetIterator,
                                                   RecordReaderDataSetIterator)
    if spec == "iris":
        return IrisDataSetIterator(batch=batch)
    if spec == "mnist":
        return MnistDataSetIterator(batch=batch)
    if spec == "cifar10":
        return CifarDataSetIterator(batch=batch)
    if spec.startswith("csv:"):
        # csv:<path>:<label_index>:<num_classes>
        _, path, label_idx, n_classes = spec.split(":")
        return RecordReaderDataSetIterator(
            CSVRecordReader(path), batch, label_index=int(label_idx),
            num_possible_labels=int(n_classes))
    raise SystemExit(f"Unknown --data spec {spec!r} "
                     "(iris|mnist|cifar10|csv:<path>:<label>:<classes>)")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Data-parallel training of a saved model (ParallelWrapper)")
    ap.add_argument("--model-path", required=True,
                    help="Model zip (utils.serialization format)")
    ap.add_argument("--data", required=True,
                    help="iris | mnist | cifar10 | csv:<path>:<label>:<classes>")
    ap.add_argument("--batch", type=int, default=128,
                    help="GLOBAL batch size (split over the mesh)")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--dp", type=int, default=None,
                    help="Data-parallel mesh size (default: every rank)")
    ap.add_argument("--tp", type=int, default=1,
                    help="Tensor-parallel mesh size")
    ap.add_argument("--model-output-path", default=None,
                    help="Where to save the trained model (default: in place)")
    ap.add_argument("--report-stats", action="store_true",
                    help="Print phase-timing stats (CommonSparkTrainingStats)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from deeplearning4j_tpu_torch.parallel.mesh import make_mesh
    from deeplearning4j_tpu_torch.parallel.trainer import ParallelWrapper
    from deeplearning4j_tpu_torch.utils.serialization import restore, write_model

    net = restore(args.model_path, device=args.device)
    mesh = make_mesh(dp=args.dp, tp=args.tp, device=net.device)
    wrapper = ParallelWrapper(net, mesh=mesh, tensor_parallel=args.tp > 1,
                              collect_stats=args.report_stats)
    iterator = build_iterator(args.data, args.batch)
    wrapper.fit(iterator, num_epochs=args.epochs)
    out = args.model_output_path or args.model_path
    write_model(net, out)
    result = {"saved": out, "epochs": args.epochs, "final_score": net.score()}
    if args.report_stats:
        print(wrapper.stats.to_string())
    print(json.dumps(result))


if __name__ == "__main__":
    main()
