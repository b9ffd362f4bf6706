"""The object-store tier across the two packages, on the CPU, over loopback
HTTP: the port's ``CloudObjectBackend`` / ``ObjectStoreEmulator`` /
``CachedBackend`` / ``backend_from_url`` against the JAX package's.

- ``sign_request`` gives the same hex digest for the same inputs.
- Each package's client against each package's emulator (both directions
  and the port with itself): round trips, paged listing, exists / delete,
  multipart, and the status taxonomy (404, 403, 429 and 503 with
  ``Retry-After`` onto ``retry_after_s``, a mid-transfer disconnect, rot in
  transit, a bad signature); a failed ``complete`` aborts the multipart
  upload, which is never listed.
- The same operation sequences through both packages' ``CachedBackend``
  give the same bytes and the same counters: hits and write-through,
  evictions under the byte budget, re-indexing of a directory an earlier
  instance left, a rotted entry evicted and refetched, one fetch for four
  concurrent readers.
- ``backend_from_url`` builds the same stack for every address form.
- ``CheckpointManager`` over the emulator falls back past an object rotted
  at rest, and the JAX package's manager reads what the port's wrote.

Emulators bind port 0 on 127.0.0.1; every request carries a timeout.
"""

import threading

import numpy as np
import pytest

from deeplearning4j_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from deeplearning4j_tpu.checkpoint import cache as jcache
from deeplearning4j_tpu.checkpoint import cloud as jcloud
from deeplearning4j_tpu.checkpoint import emulator as jemu
from deeplearning4j_tpu.checkpoint import storage as jstorage

from deeplearning4j_tpu_torch.checkpoint import (CheckpointManager,
                                                 PermanentStorageError, RetryingBackend,
                                                 StorageNotFoundError,
                                                 TransientStorageError)
from deeplearning4j_tpu_torch.checkpoint import cache as pcache
from deeplearning4j_tpu_torch.checkpoint import cloud as pcloud
from deeplearning4j_tpu_torch.checkpoint import emulator as pemu
from deeplearning4j_tpu_torch.checkpoint import storage as pstorage
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.updaters import Sgd

AK, SK = "test-access", "test-secret-key"
PKG = {"jax": (jcloud, jemu, jstorage), "port": (pcloud, pemu, pstorage)}
# (client package, emulator package)
PAIRS = [("port", "port"), ("jax", "port"), ("port", "jax")]


def _emu(which, **kw):
    return PKG[which][1].ObjectStoreEmulator(access_key=AK, secret_key=SK, **kw)


def _client(which, emu, bucket="lake", **kw):
    return PKG[which][0].CloudObjectBackend(emu.url, bucket, access_key=AK, secret_key=SK,
                                            timeout_s=10.0, **kw)


def _errors(which):
    st = PKG[which][2]
    return st.StorageNotFoundError, st.PermanentStorageError, st.TransientStorageError


def test_sign_request_digests_equal():
    rng = np.random.default_rng(0)
    for i in range(8):
        args = (f"secret-{i}", ["GET", "put", "POST", "DELETE"][i % 4],
                f"/bucket/key-{rng.integers(1 << 30)}", "list-type=2&max-keys=3" * (i % 2),
                f"2026101{i}T000000Z", bytes(rng.integers(0, 256, 32, dtype=np.uint8)).hex())
        assert pcloud.sign_request(*args) == jcloud.sign_request(*args)
    assert pcloud.SIGNING_SCHEME == jcloud.SIGNING_SCHEME


@pytest.mark.parametrize("client,server", PAIRS)
def test_client_against_emulator(client, server):
    """Round trips, paged listing, exists / delete, multipart and the
    status taxonomy, one client package against one emulator package."""
    not_found, permanent, transient = _errors(client)
    with _emu(server) as emu:
        c = _client(client, emu, list_page_size=3, multipart_threshold=1 << 15,
                    part_size=1 << 14)
        blobs = {f"k{i:02d}": bytes([i]) * (i + 1) for i in range(7)}
        for k, v in blobs.items():
            c.put(k, v)
        assert c.list() == sorted(blobs) and emu.pages_served >= 3
        assert c.list(prefix="k0") == sorted(blobs)
        assert all(c.get(k) == v for k, v in blobs.items())
        assert c.exists("k03") and not c.exists("nope")
        c.delete("k03")
        c.delete("k03")                                   # idempotent
        assert not c.exists("k03")
        with pytest.raises(not_found):
            c.get("k03")
        big = np.random.default_rng(7).integers(0, 256, 100_000, dtype=np.uint8).tobytes()
        c.put("big.bin", big)
        assert c.multipart_puts == 1 and emu.parts_received >= 2 and emu.completes == 1
        assert c.get("big.bin") == big and emu.in_flight_uploads() == []
        # the taxonomy: 403 permanent, 429 / 503 transient with the server's
        # Retry-After, a short body transient, rot in transit served as is
        emu.script("status", 1, op="get", code=403)
        with pytest.raises(permanent, match="403"):
            c.get("k01")
        for code, hint in ((429, 1.5), (503, 0.25)):
            emu.script("status", 1, op="get", code=code, retry_after=hint)
            with pytest.raises(transient) as ei:
                c.get("k01")
            assert ei.value.retry_after_s == hint
        emu.script("disconnect", 1, op="get")
        with pytest.raises(transient, match="short body"):
            c.get("big.bin")
        emu.script("bitrot", 1, op="get")
        rotted = c.get("big.bin")
        assert len(rotted) == len(big) and rotted != big
        assert c.get("big.bin") == big                    # faults are one-shot
        assert emu.faults_injected == 5
        bad = PKG[client][0].CloudObjectBackend(emu.url, "lake", access_key=AK,
                                                secret_key="wrong", timeout_s=10.0)
        with pytest.raises(permanent):
            bad.get("k01")
        assert emu.auth_rejections >= 1


@pytest.mark.parametrize("client,server", PAIRS)
def test_failed_complete_aborts_multipart(client, server):
    """A 503 on ``complete`` makes the client abort: the object is never
    visible or listed and no upload stays in flight; with the abort
    failing too, ``clean_orphans`` reaps the upload; the retry layer heals
    a torn complete by uploading again."""
    _, _, transient = _errors(client)
    with _emu(server) as emu:
        c = _client(client, emu, multipart_threshold=1 << 14, part_size=1 << 13)
        data = b"\xab" * 50_000
        emu.script("status", 1, op="complete", code=503)
        with pytest.raises(transient):
            c.put("torn.bin", data)
        assert not c.exists("torn.bin") and c.list() == []
        assert emu.in_flight_uploads() == [] and c.multipart_aborts == 1
        emu.script("status", 1, op="complete", code=503)
        emu.script("status", 1, op="abort", code=503)
        with pytest.raises(transient):
            c.put("torn2.bin", data)
        assert len(emu.in_flight_uploads()) == 1
        c.put("tmp-stage.bin", b"leftover")
        assert c.clean_orphans() == ["tmp-stage.bin"]
        assert c.uploads_aborted == 1 and emu.in_flight_uploads() == []
        emu.script("status", 1, op="complete", code=503)
        retry = PKG[client][2].RetryingBackend(c, base_backoff_s=0.01, max_backoff_s=0.1)
        retry.put("healed.bin", data)
        assert c.get("healed.bin") == data and c.list() == ["healed.bin"]


class _Counting:
    """An in-memory store that counts gets, optionally slowed by an event."""

    def __init__(self, store_cls, gate=None):
        self.store = store_cls()
        self.gets = 0
        self.gate = gate

    def wrap(self):
        store, orig = self.store, self.store.get

        def get(name):
            self.gets += 1
            if self.gate is not None:
                self.gate.wait(2.0)
            return orig(name)
        store.get = get
        return store


def _cache_run(which, tmp_path) -> list:
    """One scripted sequence through ``which``'s CachedBackend; returns
    every observable: bytes read, inner gets and the stats after each act."""
    st, cache = PKG[which][2], {"jax": jcache, "port": pcache}[which]
    out = []
    counting = _Counting(st.ObjectStoreBackend)
    inner = counting.wrap()
    root = str(tmp_path / which)
    cb = cache.CachedBackend(inner, root, max_bytes=1000)
    cb.put("a", b"alpha")                                 # write-through fill
    out.append((cb.get("a"), counting.gets))              # disk hit
    inner.put("b", b"beta")                               # behind the cache
    out.append((cb.get("b"), cb.get("b"), counting.gets))  # miss + fill, hit
    for k, size in (("c", 400), ("d", 400), ("e", 900)):
        cb.put(k, bytes(size))                            # evictions
    out.append(cb.stats())
    inner.put("big", bytes(5000))                         # over budget: bypass
    out.append((cb.get("big") == bytes(5000), cb.stats()))
    cb.put("r", b"payload-bytes")
    path = f"{root}/{cache.CachedBackend._stem('r')}.bin"
    rotted = bytearray(open(path, "rb").read())
    rotted[0] ^= 0xFF
    open(path, "wb").write(bytes(rotted))                 # rot at rest
    before = counting.gets
    out.append((cb.get("r"), counting.gets - before, cb.stats()))
    cb2 = cache.CachedBackend(inner, root, max_bytes=1000)  # re-index the dir
    out.append((cb2.stats(), cb2.get("r"), cb2.stats()))
    gate = threading.Event()
    slow = _Counting(st.ObjectStoreBackend, gate)
    slow_inner = slow.wrap()
    slow_inner.put("s", b"x" * 100)
    cb3 = cache.CachedBackend(slow_inner, str(tmp_path / f"{which}-sf"), max_bytes=1 << 20)
    results = []
    threads = [threading.Thread(target=lambda: results.append(cb3.get("s")))
               for _ in range(4)]
    for t in threads:
        t.start()
    gate.set()
    for t in threads:
        t.join(5.0)
    out.append((results, slow.gets, cb3.stats()["single_flight_waits"] >= 1))
    return out


def test_cached_backend_same_counters_as_jax(tmp_path):
    """Hits, misses, evictions, the over-budget bypass, a corrupt entry
    evicted and refetched, re-indexing and single flight: the same
    sequence gives the same bytes and counters in both packages."""
    port, jax_ = _cache_run("port", tmp_path), _cache_run("jax", tmp_path)
    assert port[:-1] == jax_[:-1]
    (results, gets, waited), (jresults, jgets, _) = port[-1], jax_[-1]
    assert results == jresults == [b"x" * 100] * 4
    assert gets == jgets == 1 and waited                  # one fetch, four readers
    stats = port[2]
    assert stats["evictions"] >= 1 and stats["bytes_cached"] <= 1000
    assert port[4][1] == 1 and port[4][2]["corrupt_evictions"] == 1
    assert port[5][0]["entries"] >= 1


def test_backend_from_url_every_form(tmp_path):
    """Every address form builds the same stack in both packages."""
    forms = ["mem:", "mem:bucket-b", f"file:{tmp_path}/s", str(tmp_path / "s2"),
             "http://127.0.0.1:1/b"]

    def shape(backend):
        out = [type(backend).__name__]
        inner = getattr(backend, "inner", None)
        while inner is not None:
            out.append(type(inner).__name__)
            inner = getattr(inner, "inner", None)
        return out

    for url in forms:
        for cache_dir in (None, str(tmp_path / "cache")):
            kw = dict(access_key=AK, secret_key=SK, cache_dir=cache_dir)
            assert shape(pcloud.backend_from_url(url, **kw)) == \
                shape(jcloud.backend_from_url(url, **kw)), (url, cache_dir)
    assert shape(pcloud.backend_from_url("http://127.0.0.1:1/b", retries=0)) == [
        "CloudObjectBackend"]
    cached = pcloud.backend_from_url("mem:", cache_dir=str(tmp_path / "c2"), cache_bytes=1234)
    assert cached.max_bytes == 1234
    for bad in ("http://127.0.0.1:1/", "http://127.0.0.1:1/a/b"):
        with pytest.raises(ValueError):
            pcloud.backend_from_url(bad)


def _net():
    conf = (NeuralNetConfiguration.builder()
            .seed(7).updater(Sgd(learning_rate=0.05)).weight_init("xavier").list()
            .layer(DenseLayer(n_out=8, activation="tanh"))
            .layer(OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(InputType.feed_forward(4))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


@pytest.mark.parametrize("server", ["port", "jax"])
def test_checkpoint_manager_over_the_wire_falls_back_past_bitrot(server, tmp_path):
    """The port's manager on backend_from_url (retries and a disk cache)
    over an emulator: restore_latest comes back at the newest step; an
    object rotted at rest (its cached copy gone too) makes it fall back
    one step; the JAX package's manager reads the same bucket."""
    rng = np.random.default_rng(0)
    x = rng.random((96, 4), np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 96)]
    batches = DataSet(x, y).split(32)
    with _emu(server) as emu:
        url = emu.bucket_url("ckpt")
        store = pcloud.backend_from_url(url, access_key=AK, secret_key=SK,
                                        cache_dir=str(tmp_path / "cache"), cache_bytes=1 << 20)
        assert isinstance(store.inner, RetryingBackend)
        cm = CheckpointManager(storage=store, async_write=False, device="cpu")
        net = _net()
        net.fit(batches[0])
        cm.save(net)
        net.fit(batches[1])
        newest = cm.save(net)
        assert cm.restore_latest()._resume_state.step == 2
        assert store.stats()["hits"] >= 1                 # restored from the disk
        faults = emu.faults_injected
        emu.script("status", 2, op="get", code=503, retry_after=0.01)
        jcm = JaxCheckpointManager(storage=jcloud.backend_from_url(
            url, access_key=AK, secret_key=SK))
        assert [e["step"] for e in jcm.checkpoints()] == [1, 2]
        jnet = jcm.restore_latest()
        assert emu.faults_injected == faults + 2          # healed by its retries
        np.testing.assert_array_equal(np.asarray(jnet.params[0]["W"]),
                                      net.params[0]["W"].numpy())
        emu.flip_byte("ckpt", newest, offset=200)         # rot at rest
        # the cached copy was verified when it was filled and is still whole
        assert cm.restore_latest()._resume_state.step == 2
        cold = CheckpointManager(storage=pcloud.backend_from_url(
            url, access_key=AK, secret_key=SK), device="cpu")
        assert cold.restore_latest()._resume_state.step == 1
        cm.close()


def test_status_errors_are_the_storage_taxonomy():
    """The port's client raises the port's storage errors (the retry layer
    and the manager's fall-back key on them)."""
    with _emu("jax") as emu:
        c = _client("port", emu)
        with pytest.raises(StorageNotFoundError):
            c.get("missing")
        emu.script("status", 1, op="put", code=400)
        with pytest.raises(PermanentStorageError):
            c.put("k", b"v")
        emu.script("status", 1, op="put", code=408)
        with pytest.raises(TransientStorageError):
            c.put("k", b"v")
        c.put("k", b"v")
        assert c.get("k") == b"v"
