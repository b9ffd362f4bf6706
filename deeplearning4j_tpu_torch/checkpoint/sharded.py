"""Sharded checkpoints with N→M reshard-on-restore (counterpart of
``deeplearning4j_tpu/checkpoint/sharded.py``, over the same shard zip).

A checkpoint can be written as a SET of shard objects, each holding the
blocks of the state one host owns, journaled by the manifest as one entry
(per-shard sha256, committed only after every shard is durable — see
``CheckpointManager._save_sharded``). Restore fetches every shard named by
the entry, verifies each against its journaled sha256, reassembles full
host arrays from the blocks and builds the model as
``utils.serialization.restore_checkpoint`` does. Because assembly produces
the whole state on the host, the restoring world need not match the
writing one: a set written by 4 hosts restores into 1.

One process writes here. The JAX package derives block ownership from a
``jax.Array``'s sharding (the device with the smallest id owns each index
block); torch tensors of one process carry no such placement, so
:func:`shard_snapshot` writes every leaf whole as host 0's shard.
:func:`simulated_shard_snapshots` row-partitions the leaves over N
synthetic hosts exactly as the JAX package's does, so the multi-shard
assemble / restore path runs in one process.

The shard zip is the JAX package's member for member:
``metadata.json`` (``"shard": true``, host, num_hosts, ...),
``configuration.json``, ``blockindex.json`` (one entry a block: tree,
leaf key, global shape, dtype, index) and ``blocks.npz``. Leaf keys are
the ``_path_key`` keys of ``coefficients.npz`` / ``updaterState.npz``
(``utils/serialization.py``), listed in the JAX package's flatten order,
so a set either package writes restores in the other, and
:func:`state_sha` gives the same digest for the same state in both.

The random stream does not cross, as in the whole-zip format: the JAX
package's host-0 shard holds a threefry key (``rngState.npz``,
``"has_rng": true``), which the port ignores (its dropout generator is
seeded anew from the configuration); the port's holds its generator state
in ``torchGeneratorState.npz`` with ``"has_rng": false``, which the JAX
package ignores.

Shard objects are named ``shard-<base>.d<k>of<M>.zip`` — a prefix the
manifest's ``scan_checkpoint_files`` (``ckpt-*``) never matches;
:func:`scan_shard_sets` rebuilds sharded entries from *complete* sets
only (an incomplete set — a crash between shard puts and the journal
write — is ignored, like a tmp/ orphan).
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import re
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np

log = logging.getLogger(__name__)

SHARD_PREFIX = "shard-"
SHARD_FORMAT_VERSION = 1
_SHARD_RE = re.compile(
    r"^shard-(ckpt-(\d{10})-(\d{5}))\.d(\d{3})of(\d{3})\.zip$")

__all__ = [
    "ShardedCheckpointError", "shard_snapshot", "simulated_shard_snapshots",
    "shard_zip_bytes", "shard_object_name", "restore_from_payloads",
    "restore_sharded", "scan_shard_sets", "state_sha", "SHARD_PREFIX",
    "shard_block_summary", "fetch_blocks",
]


class ShardedCheckpointError(RuntimeError):
    """A shard set is unusable: missing/corrupt shard, incomplete block
    coverage, or shards from mismatched checkpoints. The manager's restore
    walk treats it like any torn checkpoint — fall back a generation,
    never assemble a mixed or partial state."""


# ------------------------------------------------------------- leaf order
def _flat_keys(tree, prefix: str, out: List[str]) -> List[str]:
    """The ``_path_key`` keys of ``tree``'s leaves in ``jax.tree_util``'s
    flatten order: a dict's keys sorted, a list's entries by index."""
    items = (sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree))
    for k, v in items:
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            _flat_keys(v, key, out)
        else:
            out.append(key)
    return out


def _updater_keys(model) -> List[str]:
    """``updaterState.npz``'s keys in the flatten order of the JAX
    package's optax state: layers by index (or sorted vertex name), in a
    layer the chain's positions in order, the count before the slots
    (``ScaleByAdamState(count, mu, nu)``) and the slots by field order,
    which is their sorted order for every updater."""
    from deeplearning4j_tpu_torch.utils.serialization import _layout
    out: List[str] = []
    ups = model._updaters
    layers = sorted(ups.items()) if isinstance(ups, dict) else enumerate(ups)
    for k, updater in layers:
        pos, counting, scheduled = _layout(updater)
        if counting:
            out.append(f"{k}/0/count")
        for slot in sorted(updater._slots):
            _flat_keys(model.opt_state[k][slot], f"{k}/{pos}/{slot}", out)
        if scheduled:
            out.append(f"{k}/1/count")
    return out


def _ordered_state(model) -> Tuple[dict, dict, dict, Optional[dict]]:
    """A finished host snapshot of ``model`` (``snapshot_training_state``)
    with its coefficient and updater arrays reordered into the JAX
    package's leaf order: ``(snapshot, coefficients, updater, generator)``."""
    from deeplearning4j_tpu_torch.utils.serialization import snapshot_training_state
    snap = snapshot_training_state(model)
    coeff_src, upd_src = snap["coefficients"], snap["updater_state"]
    coeff = {k: coeff_src[k] for k in _flat_keys([model.params, model.state], "", [])}
    upd = {k: np.asarray(upd_src[k]) for k in _updater_keys(model)}
    if set(coeff) != set(coeff_src) or set(upd) != set(upd_src):
        raise ShardedCheckpointError("leaf keys of the snapshot and of the flatten "
                                     "order disagree")
    return snap, coeff, upd, snap["generator"]


def _whole_blocks(arrays: dict) -> List[dict]:
    return [{"leaf": k, "shape": list(a.shape), "dtype": str(a.dtype),
             "index": tuple((0, d) for d in a.shape), "data": a}
            for k, a in arrays.items()]


# ---------------------------------------------------------------- snapshots
def shard_snapshot(model) -> dict:
    """This process's shard of everything exact-step resume needs: every
    leaf whole (one process owns everything), the counters and the dropout
    generator's state. The copies are finished when this returns."""
    if model.params is None:
        model.init()
    snap, coeff, upd, gen = _ordered_state(model)
    return {
        "grad_compression": snap["grad_compression"],
        "compressState": (None if snap["compress_state"] is None
                          else _whole_blocks(snap["compress_state"])),
        "model_type": snap["model_type"],
        "conf_json": snap["conf_json"],
        "iteration": snap["iteration"],
        "epoch": snap["epoch"],
        "host": 0,
        "num_hosts": 1,
        "coefficients": _whole_blocks(coeff),
        "updaterState": _whole_blocks(upd),
        "generator": gen,
        "augmentation": snap["augmentation"],
        "tuning_record": snap["tuning_record"],
    }


def simulated_shard_snapshots(model, num_hosts: int) -> List[dict]:
    """``num_hosts`` synthetic host shards of a single-process model —
    each leaf row-partitioned into contiguous chunks (leaves too small to
    split belong to host 0), as the JAX package's function splits them.
    Lets one process run the multi-shard assemble/restore path a real
    N-host job produces."""
    if model.params is None:
        model.init()
    snap, coeff, upd, gen = _ordered_state(model)

    def split(arrays, host):
        out = []
        for key, a in arrays.items():
            gshape = tuple(a.shape)
            if a.ndim >= 1 and a.shape[0] >= num_hosts:
                bounds = np.linspace(0, a.shape[0], num_hosts + 1).astype(int)
                lo, hi = int(bounds[host]), int(bounds[host + 1])
                if lo == hi:
                    continue
                index = ((lo, hi),) + tuple((0, d) for d in a.shape[1:])
                data = a[lo:hi]
            elif host == 0:
                index = tuple((0, d) for d in gshape)
                data = a
            else:
                continue
            out.append({"leaf": key, "shape": list(gshape), "dtype": str(a.dtype),
                        "index": index, "data": data})
        return out

    cs = snap["compress_state"]
    return [{
        "grad_compression": snap["grad_compression"],
        "compressState": None if cs is None else split(cs, host),
        "model_type": snap["model_type"],
        "conf_json": snap["conf_json"],
        "iteration": snap["iteration"],
        "epoch": snap["epoch"],
        "host": host,
        "num_hosts": num_hosts,
        "coefficients": split(coeff, host),
        "updaterState": split(upd, host),
        "generator": gen if host == 0 else None,
        "augmentation": snap["augmentation"],
        "tuning_record": snap["tuning_record"],
    } for host in range(num_hosts)]


# ------------------------------------------------------------------- format
def shard_object_name(base: str, host: int, num_hosts: int) -> str:
    return f"{SHARD_PREFIX}{base}.d{host:03d}of{num_hosts:03d}.zip"


def shard_zip_bytes(snap: dict, extra_meta: Optional[dict] = None) -> bytes:
    """One host shard as zip bytes (ZIP_STORED): metadata + config + a
    block index + the block arrays, plus the generator state on host 0."""
    from deeplearning4j_tpu_torch.utils.serialization import GENERATOR_MEMBER
    gen = snap.get("generator")
    meta = {
        "format_version": SHARD_FORMAT_VERSION,
        "shard": True,  # manifest rebuild must never mistake this for a
        "model_type": snap["model_type"],  # whole checkpoint
        "iteration": snap["iteration"],
        "epoch": snap["epoch"],
        "host": snap["host"],
        "num_hosts": snap["num_hosts"],
        "has_updater": snap["updaterState"] is not None,
        "has_rng": False,
        "has_torch_generator": gen is not None,
        "torch_generator_device": None if gen is None else gen["device"],
        "grad_compression": snap.get("grad_compression"),
        "has_compress": snap.get("compressState") is not None,
        "augmentation": snap.get("augmentation"),
        "tuning_record": snap.get("tuning_record"),
    }
    meta.update(extra_meta or {})
    index, arrays = [], {}
    # distinct per-tree key prefixes, as the JAX package writes them;
    # readers resolve keys through blockindex.json
    for tree, prefix in (("coefficients", "c"), ("updaterState", "u"),
                         ("compressState", "x")):
        for i, b in enumerate(snap.get(tree) or []):
            key = f"{prefix}{i}"
            index.append({"key": key, "tree": tree, "leaf": b["leaf"],
                          "shape": b["shape"], "dtype": b["dtype"],
                          "index": [list(p) for p in b["index"]]})
            arrays[key] = b["data"]
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_STORED) as z:
        z.writestr("metadata.json", json.dumps(meta))
        z.writestr("configuration.json", snap["conf_json"])
        z.writestr("blockindex.json", json.dumps(index))
        bbuf = io.BytesIO()
        np.savez(bbuf, **arrays)
        z.writestr("blocks.npz", bbuf.getvalue())
        if gen is not None:
            gbuf = io.BytesIO()
            states = {"state": gen["state"]}
            if gen.get("augment_state") is not None:
                states["augment_state"] = gen["augment_state"]
            np.savez(gbuf, **states)
            z.writestr(GENERATOR_MEMBER, gbuf.getvalue())
    return buf.getvalue()


def _parse_shard(data: bytes) -> dict:
    from deeplearning4j_tpu_torch.utils.serialization import GENERATOR_MEMBER
    try:
        with zipfile.ZipFile(io.BytesIO(data), "r") as z:
            meta = json.loads(z.read("metadata.json"))
            conf_json = z.read("configuration.json").decode()
            index = json.loads(z.read("blockindex.json"))
            blocks = dict(np.load(io.BytesIO(z.read("blocks.npz"))))
            generator = None
            if meta.get("has_torch_generator") and GENERATOR_MEMBER in z.namelist():
                generator = dict(np.load(io.BytesIO(z.read(GENERATOR_MEMBER))))
    except (zipfile.BadZipFile, KeyError, ValueError, OSError) as e:
        raise ShardedCheckpointError(
            f"unreadable shard ({type(e).__name__}: {e})") from e
    return {"meta": meta, "conf_json": conf_json, "index": index,
            "blocks": blocks, "generator": generator}


# ----------------------------------------------------------------- assembly
def _assemble(parsed: List[dict], tree: str) -> Dict[str, np.ndarray]:
    """Full host arrays from every shard's blocks of ``tree``. Coverage is
    enforced: duplicated (leaf, index) blocks and block element counts
    that do not sum to the leaf's size both raise — a partial or doubled
    assembly must never restore silently."""
    leaves: Dict[str, dict] = {}
    seen = set()
    for p in parsed:
        for ent in p["index"]:
            if ent["tree"] != tree:
                continue
            key = (ent["leaf"], tuple(tuple(x) for x in ent["index"]))
            if key in seen:
                raise ShardedCheckpointError(
                    f"duplicate block for leaf '{ent['leaf']}' at "
                    f"{ent['index']} across shards")
            seen.add(key)
            data = p["blocks"][ent["key"]]
            info = leaves.setdefault(ent["leaf"], {
                "shape": tuple(ent["shape"]),
                "array": np.empty(tuple(ent["shape"]),
                                  dtype=np.dtype(ent["dtype"])),
                "filled": 0,
            })
            sl = tuple(slice(a, b) for a, b in ent["index"])
            info["array"][sl] = data
            info["filled"] += int(np.prod(data.shape, dtype=np.int64))
    out = {}
    for leaf, info in leaves.items():
        want = int(np.prod(info["shape"], dtype=np.int64))
        if info["filled"] != want:
            raise ShardedCheckpointError(
                f"incomplete coverage for leaf '{leaf}': {info['filled']} "
                f"of {want} elements present — missing or torn shard")
        out[leaf] = info["array"]
    return out


def restore_from_payloads(payloads: List[bytes], load_updater: bool = True,
                          device=None):
    """(model, meta) from a complete list of shard payload bytes, the
    network built on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``). Every shard must agree on (model_type, iteration,
    epoch, num_hosts) and the list must hold exactly ``num_hosts`` shards —
    shards from different checkpoint generations can never silently mix."""
    import torch
    from deeplearning4j_tpu_torch.nn.conf.graph import ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.training import _keyed
    from deeplearning4j_tpu_torch.utils.serialization import (_restore_tree,
                                                              _updater_state)
    parsed = [_parse_shard(d) for d in payloads]
    idents = {(p["meta"]["model_type"], p["meta"]["iteration"],
               p["meta"]["epoch"], p["meta"]["num_hosts"]) for p in parsed}
    if len(idents) != 1:
        raise ShardedCheckpointError(
            f"shards disagree on checkpoint identity: {sorted(idents)} — "
            "refusing to mix generations")
    num_hosts = int(parsed[0]["meta"]["num_hosts"])
    hosts = sorted(int(p["meta"].get("host", -1)) for p in parsed)
    if hosts != list(range(num_hosts)):
        raise ShardedCheckpointError(
            f"shard set holds hosts {hosts} but the checkpoint was "
            f"written by hosts 0..{num_hosts - 1} — missing or "
            "duplicated shard")
    meta_p = next(p for p in parsed if p["meta"].get("host") == 0)
    meta = meta_p["meta"]
    conf_json = meta_p["conf_json"]
    if meta["model_type"] == "MultiLayerNetwork":
        model = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json), device)
    else:
        model = ComputationGraph(ComputationGraphConfiguration.from_json(conf_json),
                                 device)
    model.init()  # the trees to fill, and the generator seeded anew
    coeff = _assemble(parsed, "coefficients")
    model.set_params(_restore_tree(model.params, coeff, "0", model.device),
                     _restore_tree(model.state, coeff, "1", model.device))
    iteration = int(meta.get("iteration", 0))
    if load_updater and meta.get("has_updater"):
        upd = _assemble(parsed, "updaterState")
        template = model.opt_state
        model.opt_state = _keyed(model._updaters, lambda k, u: _updater_state(
            k, u, template[k], upd, iteration, model.device))
    gen = meta_p["generator"]
    if gen is not None:
        if meta.get("torch_generator_device") == model.device.type:
            model._gen.set_state(torch.from_numpy(gen["state"].copy()))
            if "augment_state" in gen:
                model._aug_gen.set_state(torch.from_numpy(gen["augment_state"].copy()))
        else:
            log.warning("the shard set's dropout generator is a %s generator and this "
                        "network's is a %s one; dropout is seeded anew",
                        meta.get("torch_generator_device"), model.device.type)
    if meta.get("grad_compression"):
        # the whole zip's policy (parallel/compress.py): the residuals are
        # replicated, so they restore onto any world size
        from deeplearning4j_tpu_torch.parallel.compress import restore_compress_state
        cs = _assemble(parsed, "compressState") if meta.get("has_compress") else None
        restore_compress_state(model, meta["grad_compression"], cs, origin="sharded")
    if meta.get("augmentation"):
        from deeplearning4j_tpu_torch.datasets.augment import ImageAugmentation
        model.set_augmentation(ImageAugmentation.from_dict(meta["augmentation"]))
    if meta.get("tuning_record"):
        from deeplearning4j_tpu_torch.perf.autotune import TuningRecord
        model._tuning_record = TuningRecord.from_dict(meta["tuning_record"])
    model.iteration = iteration
    model.epoch = int(meta.get("epoch", 0))
    return model, meta


def shard_block_summary(payload: bytes) -> List[dict]:
    """The (tree, leaf, index) coverage of one shard payload — journaled
    per shard at save time so a selective restore can decide which shard
    OBJECTS it needs without fetching any of them."""
    return [{"tree": e["tree"], "leaf": e["leaf"], "index": e["index"]}
            for e in _parse_shard(payload)["index"]]


def fetch_blocks(storage, entry: dict, want,
                 trees: Tuple[str, ...] = ("coefficients", "updaterState"),
                 ) -> Dict[str, Dict[str, List[tuple]]]:
    """Streaming reshard-on-restore: fetch ONLY the shard objects holding
    blocks ``want`` selects, instead of reassembling the full state.

    ``want(tree, leaf, index)`` (index = ((start, stop), ...) over the
    leaf's global shape) returns whether the restoring host needs that
    block. Shards whose journaled block summary (written by
    ``CheckpointManager._save_sharded``) contains no wanted block are never
    fetched; entries without summaries (a rebuilt journal) fetch every
    shard. Fetched shards are sha-verified like a full restore.

    Returns ``{tree: {leaf: [(index, array), ...]}}`` holding exactly the
    wanted blocks, as host arrays."""
    fetched: Dict[str, Dict[str, List[tuple]]] = {t: {} for t in trees}
    for s in entry.get("shards", []):
        summary = s.get("blocks")
        if summary is not None:
            wanted = any(
                b["tree"] in trees
                and want(b["tree"], b["leaf"],
                         tuple(tuple(p) for p in b["index"]))
                for b in summary)
            if not wanted:
                continue
        data = storage.get(s["file"])
        if s.get("sha256") is not None and \
                hashlib.sha256(data).hexdigest() != s["sha256"]:
            raise ShardedCheckpointError(
                f"checksum mismatch for shard {s['file']} (torn/corrupt)")
        parsed = _parse_shard(data)
        for ent in parsed["index"]:
            if ent["tree"] not in trees:
                continue
            index = tuple(tuple(p) for p in ent["index"])
            if not want(ent["tree"], ent["leaf"], index):
                continue
            fetched[ent["tree"]].setdefault(ent["leaf"], []).append(
                (index, parsed["blocks"][ent["key"]]))
    return fetched


def restore_sharded(storage, entry: dict, load_updater: bool = True, device=None):
    """(model, meta) for a manifest shard-set entry: fetch every shard,
    verify each against its journaled sha256 (when present), reassemble.
    Any failure raises — the manager's restore walk falls back one whole
    generation rather than ever mixing shard sets."""
    payloads = []
    for s in entry.get("shards", []):
        data = storage.get(s["file"])  # StorageNotFoundError if gone
        if s.get("sha256") is not None and \
                hashlib.sha256(data).hexdigest() != s["sha256"]:
            raise ShardedCheckpointError(
                f"checksum mismatch for shard {s['file']} (torn/corrupt)")
        payloads.append(data)
    return restore_from_payloads(payloads, load_updater=load_updater, device=device)


def scan_shard_sets(storage) -> List[dict]:
    """Degraded-mode recovery (manifest lost/torn): rebuild shard-set
    entries from COMPLETE sets present in storage, in (step, seq) order.
    Incomplete sets — a crash landed between shard puts and the journal
    write — are skipped, like tmp/ orphans; per-shard zip metadata still
    gates restore via :func:`restore_from_payloads`'s identity checks."""
    groups: Dict[str, dict] = {}
    for name in storage.list(prefix=SHARD_PREFIX):
        m = _SHARD_RE.match(name)
        if not m:
            continue
        base, step, seq, host, num = (m.group(1), int(m.group(2)),
                                      int(m.group(3)), int(m.group(4)),
                                      int(m.group(5)))
        g = groups.setdefault(base, {"step": step, "seq": seq,
                                     "num_hosts": num, "files": {}})
        g["files"][host] = name
    entries = []
    for base, g in groups.items():
        if set(g["files"]) != set(range(g["num_hosts"])):
            log.warning("ignoring incomplete shard set %s (%d of %d shards "
                        "present)", base, len(g["files"]), g["num_hosts"])
            continue
        entries.append({
            "file": f"{base}.sharded",
            "sharded": True,
            "num_hosts": g["num_hosts"],
            "shards": [{"file": g["files"][h], "sha256": None}
                       for h in range(g["num_hosts"])],
            "step": g["step"],
            "seq": g["seq"],
            "sha256": None,
        })
    entries.sort(key=lambda e: (e["step"], e["seq"]))
    return entries


# ---------------------------------------------------------------- utilities
def state_sha(model) -> str:
    """Deterministic digest over parameters + layer state + updater state,
    leaf by leaf in the JAX package's flatten order with each leaf's shape
    and dtype, so the same state gives the same digest in both packages
    and a checkpoint restored into any world size gives the digest it was
    saved with; the gradient-compression state (residual, controller,
    accumulators) follows the updater state when the model has one."""
    snap, coeff, upd, _ = _ordered_state(model)
    h = hashlib.sha256()
    for arrays in (coeff, upd, snap["compress_state"] or {}):
        for a in arrays.values():
            a = np.ascontiguousarray(np.asarray(a))
            h.update(str((a.shape, str(a.dtype))).encode())
            h.update(a.tobytes())
    return h.hexdigest()
