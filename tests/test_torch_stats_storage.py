"""The port's stats storage (``storage/``) against the JAX package's, on the
CPU: a JSON-lines stats file written by either package is read by the other
with the same answer to every query; the storage events fire in the same
order; a file appended by another writer is tailed alike, a torn last line
included; and each package's ``RemoteUIStatsStorageRouter`` posts into the
other package's ``UIServer``. Records are the listener's shape (static and
update records of two sessions, two workers), built from fixed seeds.
"""

import json

import numpy as np
import pytest

from deeplearning4j_tpu import storage as jst
from deeplearning4j_tpu.storage import remote as jremote
from deeplearning4j_tpu.ui import server as jserver

from deeplearning4j_tpu_torch import storage as pst
from deeplearning4j_tpu_torch.storage import remote as premote
from deeplearning4j_tpu_torch.ui import server as pserver

PKG = {"jax": (jst, jremote, jserver), "torch": (pst, premote, pserver)}
TYPE = "StatsListener"


def _records(seed=0):
    """Static and update records of two sessions, two workers each, with
    interleaved timestamps (ties broken by iteration)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in ("sess-a", "sess-b"):
        for w in ("w0", "w1"):
            out.append({"kind": "static", "session_id": s, "type_id": TYPE, "worker_id": w,
                        "timestamp": 100.0, "software": {"python": "3.12"},
                        "model": {"num_params": int(rng.integers(10, 1000))}})
            for it in range(4):
                out.append({"kind": "update", "session_id": s, "type_id": TYPE,
                            "worker_id": w, "timestamp": float(100 + it // 2),
                            "iteration": it, "score": float(rng.standard_normal()),
                            "parameters": {"0_W": {"mean": float(rng.standard_normal())}}})
    out.append({"kind": "update", "session_id": "sess-a", "type_id": "ActivationsListener",
                "worker_id": "w0", "timestamp": 101.5, "iteration": 0, "layers": {}})
    return out


def _write(pkg, path, records):
    st = PKG[pkg][0].FileStatsStorage(str(path))
    for r in records:
        (st.put_static_info if r["kind"] == "static" else st.put_update)(r)
    st.close()


def _queries(st):
    """Every query of the read API, over every session / type / worker."""
    out = {"sessions": st.list_session_ids()}
    for s in out["sessions"] + ["missing"]:
        out[s, "exists"] = st.session_exists(s)
        out[s, "types"] = st.list_type_ids(s)
        for t in out[s, "types"] + [TYPE]:
            out[s, t, "workers"] = st.list_worker_ids(s, t)
            out[s, t, "num"] = st.num_update_records(s, t)
            out[s, t, "static"] = st.get_static_info(s, t)
            out[s, t, "latest"] = st.get_latest_update(s, t)
            out[s, t, "after"] = st.get_all_updates_after(s, t, 100.5)
            for w in out[s, t, "workers"] + [None]:
                out[s, t, w, "all"] = st.get_all_updates(s, t, w)
                out[s, t, w, "static"] = st.get_static_info(s, t, w)
        out[s, "workers"] = st.list_worker_ids(s)
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_stats_file_read_by_the_other_package(tmp_path, writer, reader):
    path = tmp_path / "stats.jsonl"
    _write(writer, path, _records())
    got = PKG[reader][0].FileStatsStorage(str(path))
    own = PKG[writer][0].FileStatsStorage(str(path))
    try:
        assert _queries(got) == _queries(own)
        assert got.num_update_records("sess-a", TYPE) == 8
    finally:
        got.close()
        own.close()
    # and the two packages write the same bytes
    other = tmp_path / "other.jsonl"
    _write(reader, other, _records())
    assert other.read_bytes() == path.read_bytes()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_in_memory_storage_answers_as_the_file(tmp_path, pkg):
    mem = PKG[pkg][0].InMemoryStatsStorage()
    for r in _records(1):
        (mem.put_static_info if r["kind"] == "static" else mem.put_update)(r)
    _write("jax", tmp_path / "s.jsonl", _records(1))
    f = pst.FileStatsStorage(str(tmp_path / "s.jsonl"))
    assert _queries(mem) == _queries(f)
    f.close()


def _events(pkg):
    st = PKG[pkg][0].InMemoryStatsStorage()
    seen = []
    cb = lambda ev: seen.append((ev.event_type, ev.session_id, ev.type_id, ev.worker_id,  # noqa: E731
                                 ev.timestamp))
    st.register_storage_listener(cb)
    for r in _records(2)[:7]:
        (st.put_static_info if r["kind"] == "static" else st.put_update)(r)
    st.deregister_storage_listener(cb)
    st.put_update(_records(2)[-1])
    return seen


def test_events_fire_alike():
    got, want = _events("torch"), _events("jax")
    assert got == want
    kinds = [e[0] for e in got]
    assert kinds[:2] == [pst.StatsStorageEvent.NEW_SESSION, pst.StatsStorageEvent.POST_STATIC_INFO]
    assert kinds.count(pst.StatsStorageEvent.POST_UPDATE) == 5
    assert kinds.count(pst.StatsStorageEvent.NEW_SESSION) == 1  # the second static: same session


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_refresh_tails_another_writer(tmp_path, pkg):
    """A reader picks up what another writer appended, and leaves a torn
    last line for the next refresh, as the JAX package's reader does."""
    path = tmp_path / "tail.jsonl"
    recs = _records(3)
    _write("jax" if pkg == "torch" else "torch", path, recs[:3])
    reader = PKG[pkg][0].FileStatsStorage(str(path))
    assert reader.num_update_records("sess-a", TYPE) == 2
    line = json.dumps(recs[3]) + "\n"
    with open(path, "a", encoding="utf-8") as f:
        f.write(line[:10])
    assert reader.refresh() == 0
    with open(path, "a", encoding="utf-8") as f:
        f.write(line[10:] + json.dumps(recs[4]) + "\n")
    assert reader.refresh() == 2
    assert reader.num_update_records("sess-a", TYPE) == 4
    reader.close()


@pytest.mark.parametrize("sender,receiver", [("torch", "jax"), ("jax", "torch")])
def test_remote_router_posts_into_the_other_ui_server(sender, receiver):
    st = PKG[receiver][0].InMemoryStatsStorage()
    server = PKG[receiver][2].UIServer(0, "127.0.0.1").attach(st)
    try:
        router = PKG[sender][1].RemoteUIStatsStorageRouter(
            f"http://127.0.0.1:{server.port}", max_retries=3, retry_backoff_s=0.01, seed=0)
        recs = _records(4)
        for r in recs:
            (router.put_static_info if r["kind"] == "static" else router.put_update)(r)
        assert router.shutdown(timeout=10.0)
        with pytest.raises(RuntimeError, match="shut down"):
            router.put_update(recs[1])
        want = PKG[sender][0].InMemoryStatsStorage()
        for r in recs:
            (want.put_static_info if r["kind"] == "static" else want.put_update)(r)
        assert _queries(st) == _queries(want)
    finally:
        server.stop()


def _failing_router(mod):
    """A router to a port nothing listens on: every post fails."""
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    router = mod.RemoteUIStatsStorageRouter(f"http://127.0.0.1:{port}/", max_retries=3,
                                            retry_backoff_s=0.001, max_backoff_s=0.002,
                                            seed=5)
    assert router.base.endswith("/remoteReceive")
    router.put_update(_records()[1])
    import time
    deadline = time.monotonic() + 10
    while router._failures < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    failures = router._failures
    router.shutdown(timeout=2.0)
    return failures


def test_router_drops_after_its_retries_alike():
    assert _failing_router(premote) == _failing_router(jremote) == 3
