"""The port's linter (``deeplearning4j_tpu_torch/analysis/lint.py`` and
``callgraph.py``) held to the JAX package's.

- Host rules (DLT004, 006, 007, 008, 011, 016, 018, 019, 021): the JAX
  package's ``tests/test_lint.py`` snippets, copied here at the same
  relative paths with the package prefix swapped, give the same
  ``(rule, line)`` lists through both linters.
- Device rules: each JAX snippet has a torch translation with the hazard
  on the same line; the port flags the translation exactly where the JAX
  linter flags the original, and neither flags the negative cases.
- Call graph: the same resolved edges, lock acquisitions and thread facts
  over ``tests/lint_fixtures/``; DLT017 through
  ``tests/lint_fixtures_torch/hostwork_pkg`` with its chains.
- The port tree lints clean under ``DEFAULT_TARGETS`` within budget, and
  ``python -m deeplearning4j_tpu_torch.tools.run_lint`` keeps the JAX
  tool's schema and exit codes.
"""

import importlib.util
import json
import os
import textwrap
import time

import pytest

from deeplearning4j_tpu.analysis import callgraph as jcg
from deeplearning4j_tpu.analysis import lint as jlint
from deeplearning4j_tpu_torch.analysis import callgraph as pcg
from deeplearning4j_tpu_torch.analysis import lint as plint
from deeplearning4j_tpu_torch.tools import run_lint as prun

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JFIX = os.path.join(REPO_ROOT, "tests", "lint_fixtures")
PFIX = os.path.join(REPO_ROOT, "tests", "lint_fixtures_torch")


def _port(path: str) -> str:
    return path.replace("deeplearning4j_tpu/", "deeplearning4j_tpu_torch/")


def _found(vs):
    return [(v.rule, v.line) for v in vs]


# --------------------------------------------------------------------------
# host rules: (id, path in the JAX tree, snippet, the rules it must raise)
# --------------------------------------------------------------------------
_LOCKS_INCONSISTENT = """
    import threading
    class Manager:
        def __init__(self):
            self._state_lock = threading.Lock()
            self._io_lock = threading.Lock()
        def writer(self):
            with self._state_lock:
                with self._io_lock:
                    pass
        def reader(self):
            with self._io_lock:
                with self._state_lock:
                    pass
"""
_SWALLOW = """
    def commit(backend, name, data):
        try:
            backend.put(name, data)
        except Exception:
            pass
"""
CKPT = "deeplearning4j_tpu/checkpoint/thing.py"

HOST_CASES = [
    # DLT004
    ("dlt004_inconsistent", "fixture.py", _LOCKS_INCONSISTENT, ["DLT004"]),
    ("dlt004_consistent", "fixture.py", """
        import threading
        class Manager:
            def writer(self):
                with self._state_lock:
                    with self._io_lock:
                        pass
            def reader(self):
                with self._state_lock:
                    with self._io_lock:
                        pass
    """, []),
    ("dlt004_combined_with", "fixture.py", """
        class M:
            def a(self):
                with self._l1_lock, self._l2_lock:
                    pass
            def b(self):
                with self._l2_lock, self._l1_lock:
                    pass
    """, ["DLT004"]),
    ("dlt004_single_lock", "fixture.py", """
        class M:
            def a(self):
                with self._lock:
                    pass
            def b(self):
                with self._lock:
                    pass
    """, []),
    ("dlt004_acquire_try_finally", "fixture.py", """
        class Pool:
            def a(self):
                self._x_lock.acquire()
                try:
                    with self._y_lock:
                        pass
                finally:
                    self._x_lock.release()
            def b(self):
                with self._y_lock:
                    self._x_lock.acquire()
                    self._x_lock.release()
    """, ["DLT004"]),
    ("dlt004_pure_acquire_release", "fixture.py", """
        class Pool:
            def a(self):
                self._x_lock.acquire()
                self._y_lock.acquire()
                self._y_lock.release()
                self._x_lock.release()
            def b(self):
                self._y_lock.acquire()
                self._x_lock.acquire()
                self._x_lock.release()
                self._y_lock.release()
    """, ["DLT004"]),
    ("dlt004_sequential_not_nesting", "fixture.py", """
        class Pool:
            def a(self):
                self._x_lock.acquire()
                self._x_lock.release()
                self._y_lock.acquire()
                self._y_lock.release()
            def b(self):
                self._y_lock.acquire()
                self._y_lock.release()
                self._x_lock.acquire()
                self._x_lock.release()
    """, []),
    ("dlt004_acquire_consistent", "fixture.py", """
        class Pool:
            def a(self):
                self._x_lock.acquire()
                try:
                    with self._y_lock:
                        pass
                finally:
                    self._x_lock.release()
            def b(self):
                self._x_lock.acquire()
                self._y_lock.acquire()
                self._y_lock.release()
                self._x_lock.release()
    """, []),
    # DLT006
    ("dlt006_swallowed", CKPT, _SWALLOW, ["DLT006"]),
    ("dlt006_bare_except_storage", "deeplearning4j_tpu/storage/thing.py", """
        def fetch(b, n):
            try:
                return b.get(n)
            except:
                return None
    """, ["DLT006"]),
    ("dlt006_logged", CKPT, """
        import logging
        log = logging.getLogger(__name__)
        def commit(backend, name, data):
            try:
                backend.put(name, data)
            except Exception as e:
                log.warning("put failed: %s", e)
    """, []),
    ("dlt006_reraise", CKPT, """
        def commit(backend, name, data):
            try:
                backend.put(name, data)
            except Exception:
                raise RuntimeError("commit failed")
    """, []),
    ("dlt006_stashed", CKPT, """
        class W:
            def work(self, item):
                try:
                    self._write(item)
                except BaseException as e:
                    self._write_err = e
    """, []),
    ("dlt006_log_substring_still_fires", CKPT, """
        class C:
            def commit(self, backend, name, data):
                try:
                    backend.put(name, data)
                except Exception:
                    self.catalog.refresh()
    """, ["DLT006"]),
    ("dlt006_narrow_handler", CKPT, """
        import os
        def prune(path):
            try:
                os.remove(path)
            except OSError:
                pass
    """, []),
    ("dlt006_out_of_scope", "deeplearning4j_tpu/nn/thing.py", _SWALLOW, []),
    ("dlt006_waiver", CKPT, _SWALLOW.replace(
        "except Exception:", "except Exception:  # lint: disable=DLT006 (probe, loss ok)"), []),
    # DLT007
    ("dlt007_missing_unit_and_help", "fixture.py", """
        from deeplearning4j_tpu.obs import get_registry
        def setup():
            registry = get_registry()
            return registry.counter("requests_total")
    """, ["DLT007"]),
    ("dlt007_missing_help", "fixture.py", """
        def setup(reg):
            return reg.gauge("depth", unit="requests")
    """, ["DLT007"]),
    ("dlt007_empty_unit", "fixture.py", """
        def setup(registry):
            return registry.histogram("lat_ms", unit="", help="x")
    """, ["DLT007"]),
    ("dlt007_full", "fixture.py", """
        def setup(registry):
            registry.counter("requests_total", unit="requests",
                             help="requests served")
            registry.histogram("lat_ms", "ms", "request latency")
    """, []),
    ("dlt007_non_registry_receiver", "fixture.py", """
        def read(watch):
            return watch.counter("attention.flash")
    """, []),
    ("dlt007_bare_counter_dict", "fixture.py", """
        class Stats:
            def __init__(self):
                self.counters = {}
    """, ["DLT007"]),
    ("dlt007_annotated_counter_dict", "fixture.py", """
        from typing import Dict
        class W:
            def __init__(self):
                self._event_counters: Dict[str, int] = {}
    """, ["DLT007"]),
    ("dlt007_unrelated_dict", "fixture.py", """
        class C:
            def __init__(self):
                self.cache = {}
                self.bucket_sizes = {}
    """, []),
    ("dlt007_waiver", "fixture.py", """
        class Stats:
            def __init__(self):
                self.counters = {}  # lint: disable=DLT007 (absorbed via obs.absorb_training_stats)
    """, []),
    # DLT008
    ("dlt008_parallel", "deeplearning4j_tpu/parallel/thing.py", """
        import queue
        class W:
            def __init__(self):
                self._q = queue.Queue()
    """, ["DLT008"]),
    ("dlt008_maxsize_zero", "deeplearning4j_tpu/serving/thing.py", """
        from queue import Queue
        def make():
            return Queue(maxsize=0)
    """, ["DLT008"]),
    ("dlt008_positional_zero", "deeplearning4j_tpu/datasets/thing.py", """
        import queue
        q = queue.Queue(0)
    """, ["DLT008"]),
    ("dlt008_bounded", "deeplearning4j_tpu/storage/thing.py", """
        import queue
        from queue import Queue
        a = queue.Queue(maxsize=64)
        b = Queue(8)
        c = queue.Queue(maxsize=depth)
    """, []),
    ("dlt008_out_of_scope", "deeplearning4j_tpu/nn/thing.py", """
        import queue
        q = queue.Queue()
    """, []),
    ("dlt008_waiver", "deeplearning4j_tpu/parallel/thing.py", """
        import queue
        q = queue.Queue()  # lint: disable=DLT008 (drained every step)
    """, []),
    # DLT011
    ("dlt011_shuffle", "deeplearning4j_tpu/datasets/fixture.py", """
        import random
        def make_epoch(items):
            random.shuffle(items)
            return items
    """, ["DLT011"]),
    ("dlt011_permutation_and_seed", "deeplearning4j_tpu/parallel/fixture.py", """
        import numpy as np
        def shard_order(n):
            np.random.seed(0)
            return np.random.permutation(n)
    """, ["DLT011", "DLT011"]),
    ("dlt011_seeded", "deeplearning4j_tpu/datasets/fixture.py", """
        import random
        import numpy as np
        def make_epoch(seed, epoch, n):
            order = np.random.default_rng([seed, epoch]).permutation(n)
            r = random.Random(seed)
            picks = [r.random() for _ in range(4)]
            return order, picks
    """, []),
    ("dlt011_out_of_scope", "deeplearning4j_tpu/serving/fixture.py", """
        import random
        def jitter(d):
            return d * random.random()
    """, []),
    ("dlt011_waiver", "deeplearning4j_tpu/datasets/fixture.py", """
        import random
        def sample_debug(items):
            return random.sample(items, 2)  # lint: disable=DLT011 (debug only)
    """, []),
    # DLT016
    ("dlt016_urlopen", "deeplearning4j_tpu/fleet/router.py", """
        import urllib.request
        def scrape(addr):
            return urllib.request.urlopen(addr + "/metrics").read()
    """, ["DLT016"]),
    ("dlt016_http_connection", "deeplearning4j_tpu/serving/server.py", """
        import http.client
        def forward(host, port):
            return http.client.HTTPConnection(host, port)
    """, ["DLT016"]),
    ("dlt016_from_import", "deeplearning4j_tpu/fleet/router.py", """
        from urllib.request import urlopen
        def scrape(addr):
            return urlopen(addr).read()
    """, ["DLT016"]),
    ("dlt016_create_connection", "deeplearning4j_tpu/fleet/router.py", """
        import socket
        def probe(addr):
            return socket.create_connection(addr)
    """, ["DLT016"]),
    ("dlt016_timeout_kwarg", "deeplearning4j_tpu/fleet/router.py", """
        import http.client
        import urllib.request
        def forward(host, port, addr):
            c = http.client.HTTPConnection(host, port, timeout=5.0)
            return c, urllib.request.urlopen(addr, timeout=2.0)
    """, []),
    ("dlt016_positional_timeout", "deeplearning4j_tpu/fleet/router.py", """
        import socket
        def probe(addr):
            return socket.create_connection(addr, 5.0)
    """, []),
    ("dlt016_out_of_scope", "deeplearning4j_tpu/datasets/fetchers.py", """
        import urllib.request
        def fetch(url):
            return urllib.request.urlopen(url).read()
    """, []),
    ("dlt016_waiver", "deeplearning4j_tpu/fleet/router.py", """
        import urllib.request
        def fetch(url):
            # deliberate unbounded wait: caller owns the deadline
            return urllib.request.urlopen(url)  # lint: disable=DLT016
    """, []),
    # DLT021
    ("dlt021_unbounded_read", "deeplearning4j_tpu/checkpoint/cloud.py", """
        import http.client
        def fetch(host):
            conn = http.client.HTTPConnection(host, timeout=5.0)
            conn.request("GET", "/o")
            return conn.getresponse().read()
    """, ["DLT021"]),
    ("dlt021_recv_readline", "deeplearning4j_tpu/checkpoint/emulator.py", """
        def drain(sock, f):
            return sock.recv(), f.readline()
    """, ["DLT021", "DLT021"]),
    ("dlt021_connection_without_timeout", "deeplearning4j_tpu/tools/lake.py", """
        import http.client
        def connect(host):
            return http.client.HTTPConnection(host)
    """, ["DLT021"]),
    ("dlt021_bounded_and_timed", "deeplearning4j_tpu/checkpoint/cloud.py", """
        import http.client
        def fetch(host, n):
            conn = http.client.HTTPConnection(host, timeout=5.0)
            conn.request("GET", "/o")
            return conn.getresponse().read(n)
    """, []),
    ("dlt021_out_of_scope", "deeplearning4j_tpu/datasets/fetchers.py", """
        def fetch(resp):
            return resp.read()
    """, []),
    ("dlt021_waiver", "deeplearning4j_tpu/checkpoint/cloud.py", """
        def drain(resp):
            # stream provably bounded by the framing layer above
            return resp.read()  # lint: disable=DLT021
    """, []),
]


@pytest.mark.parametrize("name,path,src,want", HOST_CASES,
                         ids=[c[0] for c in HOST_CASES])
def test_host_rule_parity(name, path, src, want):
    src = textwrap.dedent(src)
    jax_found = _found(jlint.lint_file(path, src=src))
    port_found = _found(plint.lint_file(_port(path), src=src))
    assert port_found == jax_found
    assert [r for r, _ in port_found] == want


# repo rules DLT018 / DLT019 over small trees: (id, {relpath: src}, rule, n)
REPO_HOST_CASES = [
    ("dlt018_same_class_is_dlt004", {"pair.py": """
        import threading
        class M:
            def __init__(self):
                self._a_lock = threading.Lock()
                self._b_lock = threading.Lock()
            def one(self):
                with self._a_lock:
                    with self._b_lock:
                        pass
            def two(self):
                with self._b_lock:
                    with self._a_lock:
                        pass
    """}, "DLT004", 1),
    ("dlt018_blocking_io_under_lock", {"serving/poller.py": """
        import threading
        import urllib.request
        class Poller:
            def __init__(self):
                self._lock = threading.Lock()
            def poll(self, url):
                with self._lock:
                    return urllib.request.urlopen(url, timeout=1.0)
    """}, "DLT018", 1),
    ("dlt018_blocking_io_through_callee", {"serving/drain.py": """
        import queue
        import threading
        class Drainer:
            def __init__(self):
                self._lock = threading.Lock()
                self._queue = queue.Queue(maxsize=8)
            def _take(self):
                return self._queue.get(timeout=0.1)
            def drain(self):
                with self._lock:
                    return self._take()
    """}, "DLT018", 1),
    ("dlt019_joined_in_sibling_method", {"worker.py": """
        import threading
        class W:
            def start(self):
                self._thread = threading.Thread(target=self._run)
                self._thread.start()
            def stop(self):
                self._thread.join()
            def _run(self):
                pass
    """}, "DLT019", 0),
    ("dlt019_daemon_true", {"daemonized.py": """
        import threading
        def spawn(fn):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
    """}, "DLT019", 0),
    ("dlt019_waived", {"spawn.py": """
        import threading
        def fire_and_forget(fn):
            t = threading.Thread(target=fn)  # lint: disable=DLT019 (process-lifetime helper)
            t.start()
    """}, "DLT019", 0),
]


def _relfound(vs, root):
    return [(v.rule, os.path.relpath(v.file, root), v.line) for v in vs]


@pytest.mark.parametrize("name,files,rule,n", REPO_HOST_CASES,
                         ids=[c[0] for c in REPO_HOST_CASES])
def test_repo_host_rule_parity(name, files, rule, n, tmp_path):
    for rel, src in files.items():
        f = tmp_path / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(textwrap.dedent(src))
    jax_found = _relfound(jlint.lint_paths([str(tmp_path)]), tmp_path)
    port_found = _relfound(plint.lint_paths([str(tmp_path)]), tmp_path)
    assert port_found == jax_found
    assert sum(r == rule for r, _, _ in port_found) == n


@pytest.mark.parametrize("fixture", ["lockpair_pkg", "leaky_threads.py"])
def test_repo_host_rules_on_the_jax_fixtures(fixture):
    """DLT018 across two classes in two files and DLT019's leaked thread:
    the same findings and messages from both linters."""
    path = os.path.join(JFIX, fixture)
    jax_found = [(v.rule, v.file, v.line, v.message) for v in jlint.lint_paths([path])]
    port_found = [(v.rule, v.file, v.line, v.message) for v in plint.lint_paths([path])]
    assert port_found == jax_found
    assert {r for r, *_ in port_found} == {"DLT018" if fixture == "lockpair_pkg"
                                           else "DLT019"}


# --------------------------------------------------------------------------
# device rules: (id, JAX path, JAX snippet, port path, torch translation with
# the hazard on the same line, the rules both raise)
# --------------------------------------------------------------------------
_BN_SERVING = """
    from deeplearning4j_tpu.nn.conf.normalization import BatchNormalization
    from deeplearning4j_tpu.parallel import ParallelInference

    def serve(builder, net_cls):
        conf = builder.layer(BatchNormalization()).build()
        net = net_cls(conf).init()
        pi = ParallelInference(net, batch_limit=8)
        return pi
"""
_PI = "pi = ParallelInference(net, batch_limit=8)"
RETR = "deeplearning4j_tpu/retrieval/thing.py"
PACK, PQ = "deeplearning4j_tpu/quant/pack.py", "deeplearning4j_tpu/retrieval/pq.py"
KERN, PKERN = "deeplearning4j_tpu/perf/pallas/fixture.py", \
    "deeplearning4j_tpu_torch/perf/kernels/fixture.py"
SERV = "deeplearning4j_tpu/serving/fixture.py"
DEC = "deeplearning4j_tpu/serving/decode.py"

DEVICE_CASES = [
    # DLT001: import-time device work
    ("dlt001_import_time", "fixture.py", """
        import jax.numpy as jnp
        TABLE = jnp.arange(1024)
    """, "fixture.py", """
        import torch
        TABLE = torch.arange(1024)
    """, ["DLT001"]),
    ("dlt001_class_body_and_default", "fixture.py", """
        import jax.numpy as jnp
        class C:
            mask = jnp.ones((4, 4))
        def f(x=jnp.zeros(3)):
            return x
    """, "fixture.py", """
        import torch
        class C:
            mask = torch.ones((4, 4))
        def f(x=torch.zeros(3)):
            return x
    """, ["DLT001", "DLT001"]),
    ("dlt001_nested_once", "fixture.py", """
        import jax.numpy as jnp
        T = jnp.cumsum(jnp.arange(4))
    """, "fixture.py", """
        import torch
        T = torch.cumsum(torch.arange(4), 0)
    """, ["DLT001"]),
    ("dlt001_cuda_call_at_import", "fixture.py", """
        import jax.numpy as jnp
        N = jnp.zeros(()).size
    """, "fixture.py", """
        import torch
        N = torch.cuda.current_device()
    """, ["DLT001"]),
    ("dlt001_inside_function", "fixture.py", """
        import jax.numpy as jnp
        def f():
            return jnp.arange(1024)
    """, "fixture.py", """
        import torch
        def f():
            return torch.arange(1024)
    """, []),
    ("dlt001_dtypes_and_devices", "fixture.py", """
        import jax.numpy as jnp
        DTYPE = jnp.float32
    """, "fixture.py", """
        import torch
        DTYPE, CPU, SHAPE = torch.float32, torch.device("cpu"), torch.Size([2])
    """, []),
    ("dlt001_waiver", "fixture.py", """
        import jax.numpy as jnp
        TABLE = jnp.arange(4)  # lint: disable=DLT001 (4 elements, cheap)
    """, "fixture.py", """
        import torch
        TABLE = torch.arange(4)  # lint: disable=DLT001 (4 elements, cheap)
    """, []),
    # DLT002: JAX clocks / host RNG in traced code; the port's global RNG in
    # a step root
    ("dlt002_decorated_root", "fixture.py", """
        import time
        import jax
        @jax.jit
        def step(x):
            t = time.time()
            return x + t
    """, "fixture.py", """
        import torch
        import torch.nn.functional as F
        @torch.compile
        def step(x):
            t = torch.rand(())
            return F.relu(x + t)
    """, ["DLT002"]),
    ("dlt002_function_handed_to_root", "fixture.py", """
        import time
        import jax
        def step(x):
            return x * time.perf_counter()
        fast = jax.jit(step)
    """, "fixture.py", """
        import torch
        from deeplearning4j_tpu_torch.perf.compile_watch import CompileWatch
        def step(x):
            return x * torch.randn(x.shape)
        watch = CompileWatch("m")
        fast = watch.wrap(step, "step")
    """, ["DLT002"]),
    ("dlt002_transform_body", "fixture.py", """
        import random
        from jax import lax
        def body(c, x):
            return c, x * random.random()
        def run(xs):
            return lax.scan(body, 0.0, xs)
    """, "fixture.py", """
        import random
        import torch
        def body(x):
            return x * random.random()
        def run(xs):
            return torch.func.vmap(body)(xs)
    """, ["DLT002"]),
    ("dlt002_lambda_handed_to_root", "fixture.py", """
        import numpy as np
        import jax
        fast = jax.jit(lambda x: x + np.random.rand())
    """, "fixture.py", """
        import numpy as np
        import torch
        fast = torch.compile(lambda x: x + np.random.rand())
    """, ["DLT002"]),
    ("dlt002_autograd_function", "fixture.py", """
        import jax
        import time
        @jax.custom_vjp
        def noisy(x):
            return x
        @jax.jit
        def step(x):
            return noisy(x) * time.time()
    """, "fixture.py", """
        import torch
        class Noisy(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return x
            @staticmethod
            def backward(ctx, g):
                return g * torch.bernoulli(torch.full_like(g, 0.5))
    """, ["DLT002"]),
    ("dlt002_host_code", "fixture.py", """
        import time
        def host_loop():
            return time.time()
    """, "fixture.py", """
        import random
        def host_loop():
            return random.random()
    """, []),
    ("dlt002_seeded_generator", "fixture.py", """
        import jax
        @jax.jit
        def step(x, key):
            return x + jax.random.normal(key, x.shape)
    """, "fixture.py", """
        import torch
        @torch.compile
        def step(x, gen):
            return x + torch.randn(x.shape, generator=gen)
    """, []),
    # DLT003: a stopwatch without a sync in bench / perf / tools files
    ("dlt003_unsynced", "tools/perf_thing.py", """
        import time
        def measure(step):
            t0 = time.perf_counter()
            step()
            return time.perf_counter() - t0
    """, "tools/perf_thing.py", """
        import time
        def measure(step):
            t0 = time.perf_counter()
            step()
            return time.perf_counter() - t0
    """, ["DLT003"]),
    ("dlt003_synced", "tools/perf_thing.py", """
        import time
        import jax
        def measure(step):
            t0 = time.perf_counter()
            jax.block_until_ready(step())
            return time.perf_counter() - t0
    """, "tools/perf_thing.py", """
        import time
        import torch
        def measure(step):
            t0 = time.perf_counter()
            torch.cuda.synchronize(step().device)
            return time.perf_counter() - t0
    """, []),
    ("dlt003_chip_smoke_in_scope", "bench_thing.py", """
        import time
        def measure(step):
            t0 = time.perf_counter()
            step()
            return time.perf_counter() - t0
    """, "chip_smoke.py", """
        import time
        def measure(step):
            t0 = time.perf_counter()
            step()
            return time.perf_counter() - t0
    """, ["DLT003"]),
    ("dlt003_out_of_scope", "deeplearning4j_tpu/whatever.py", """
        import time
        def measure(step):
            t0 = time.perf_counter()
            step()
            return time.perf_counter() - t0
    """, "deeplearning4j_tpu_torch/whatever.py", """
        import time
        def measure(step):
            t0 = time.perf_counter()
            step()
            return time.perf_counter() - t0
    """, []),
    # DLT005: BN served unfolded
    ("dlt005_unfolded", "fixture.py", _BN_SERVING, "fixture.py",
     _port(_BN_SERVING), ["DLT005"]),
    ("dlt005_fold_bn_call", "fixture.py",
     _BN_SERVING.replace(_PI, "pi = ParallelInference(fold_bn(net), batch_limit=8)"),
     "fixture.py",
     _port(_BN_SERVING).replace(_PI, "pi = ParallelInference(fold_bn(net), batch_limit=8)"),
     []),
    ("dlt005_fold_bn_kwarg", "fixture.py",
     _BN_SERVING.replace(_PI, "pi = ParallelInference(net, batch_limit=8, fold_bn=True)"),
     "fixture.py",
     _port(_BN_SERVING).replace(_PI, "pi = ParallelInference(net, batch_limit=8, "
                                     "fold_bn=True)"), []),
    ("dlt005_fold_bn_false", "fixture.py",
     _BN_SERVING.replace(_PI, "pi = ParallelInference(net, batch_limit=8, fold_bn=False)"),
     "fixture.py",
     _port(_BN_SERVING).replace(_PI, "pi = ParallelInference(net, batch_limit=8, "
                                     "fold_bn=False)"), ["DLT005"]),
    ("dlt005_no_bn", "fixture.py", """
        from deeplearning4j_tpu.parallel import ParallelInference

        def serve(net):
            return ParallelInference(net)
    """, "fixture.py", """
        from deeplearning4j_tpu_torch.parallel import ParallelInference

        def serve(net):
            return ParallelInference(net)
    """, []),
    # DLT009: host work in the compression path
    ("dlt009_np_beside_device_math", "fixture.py", """
        import numpy as np
        import jax.numpy as jnp
        def compress_gradients(grads):
            v = jnp.abs(grads)
            return np.asarray(v)
    """, "fixture.py", """
        import numpy as np
        import torch
        def compress_gradients(grads):
            v = torch.abs(grads)
            return np.asarray(v)
    """, ["DLT009"]),
    ("dlt009_item_in_compression_class", "fixture.py", """
        import jax.numpy as jnp
        class MyCompression:
            def encode(self, v):
                tau = jnp.max(jnp.abs(v))
                return float(tau.item())
    """, "fixture.py", """
        import torch
        class MyCompression:
            def encode(self, v):
                tau = torch.max(torch.abs(v))
                return float(tau.item())
    """, ["DLT009"]),
    ("dlt009_readback", "fixture.py", """
        import jax
        import jax.numpy as jnp
        def compress_step(g):
            g = jnp.sign(g)
            return jax.device_get(g)
    """, "fixture.py", """
        import torch
        import torch.nn.functional as F
        def compress_step(g):
            g = torch.sign(g)
            return g.cpu()
    """, ["DLT009"]),
    ("dlt009_implicit_sync", "fixture.py", """
        import jax
        import jax.numpy as jnp
        def compress_step(g):
            g = jnp.sign(g)
            return jax.device_get(g)
    """, "fixture.py", """
        import torch
        import torch.nn.functional as F
        def compress_step(g):
            g = torch.sign(g)
            return g.nonzero()
    """, ["DLT009"]),
    ("dlt009_pure_host_reader", "fixture.py", """
        import numpy as np
        def absorb_grad_compression(registry, model):
            acc = model.compress_state["acc"]
            return {k: float(np.asarray(v)) for k, v in acc.items()}
    """, "fixture.py", """
        import numpy as np
        def absorb_grad_compression(registry, model):
            acc = model.compress_state["acc"]
            return {k: float(np.asarray(v)) for k, v in acc.items()}
    """, []),
    ("dlt009_out_of_scope_name", "fixture.py", """
        import numpy as np
        import jax.numpy as jnp
        def stack_batches(xs):
            return jnp.asarray(np.stack(xs))
    """, "fixture.py", """
        import numpy as np
        import torch
        def stack_batches(xs):
            return torch.as_tensor(np.stack(xs))
    """, []),
    ("dlt009_waiver", "fixture.py", """
        import numpy as np
        import jax.numpy as jnp
        def compress_debug(g):
            v = jnp.abs(g)
            return np.asarray(v)  # lint: disable=DLT009 (debug dump)
    """, "fixture.py", """
        import numpy as np
        import torch
        def compress_debug(g):
            v = torch.abs(g)
            return np.asarray(v)  # lint: disable=DLT009 (debug dump)
    """, []),
    # DLT010: float casts in the int8 path
    ("dlt010_float32_cast", "fixture.py", """
        import jax.numpy as jnp
        def dequantize_layer(xq, scale):
            return xq.astype(jnp.float32) * scale
    """, "fixture.py", """
        import torch
        def dequantize_layer(xq, scale):
            return xq.to(torch.float32) * scale
    """, ["DLT010"]),
    ("dlt010_quantized_class_float64", "fixture.py", """
        import jax.numpy as jnp
        class QuantizedThingLayer:
            def apply(self, params, x):
                acc = x @ params["Wq"]
                return acc.astype("float64")
    """, "fixture.py", """
        import torch
        class QuantizedThingLayer:
            def apply(self, params, x):
                acc = x @ params["Wq"]
                return acc.double()
    """, ["DLT010"]),
    ("dlt010_float_method", "fixture.py", """
        import jax.numpy as jnp
        def dequantize_layer(xq, scale):
            return xq.astype(jnp.float32) * scale
    """, "fixture.py", """
        import torch
        def dequantize_layer(xq, scale):
            return xq.float() * scale
    """, ["DLT010"]),
    ("dlt010_float64_constructor", "fixture.py", """
        import numpy as np
        import jax.numpy as jnp
        def quantize_weights(w):
            wq = jnp.round(w)
            return np.float64(wq) / 127.0
    """, "fixture.py", """
        import numpy as np
        import torch
        def quantize_weights(w):
            wq = torch.round(w)
            return np.float64(wq) / 127.0
    """, ["DLT010"]),
    ("dlt010_pure_host_helper", "fixture.py", """
        import numpy as np
        def bench_quantized_inference():
            rng = np.random.default_rng(7)
            return rng.standard_normal((8, 4)).astype(np.float32)
    """, "fixture.py", """
        import numpy as np
        def bench_quantized_inference():
            rng = np.random.default_rng(7)
            return rng.standard_normal((8, 4)).astype(np.float32)
    """, []),
    ("dlt010_int_casts_and_scalar_wraps", "fixture.py", """
        import jax.numpy as jnp
        def quantize_activation(x, s):
            inv = jnp.float32(1.0 / s)
            return jnp.clip(jnp.round(x * inv), -127, 127).astype(jnp.int8)
    """, "fixture.py", """
        import torch
        def quantize_activation(x, s):
            inv = torch.tensor(1.0 / s, dtype=torch.float32)
            return torch.clamp(torch.round(x * inv), -127, 127).to(torch.int8)
    """, []),
    ("dlt010_out_of_scope_name", "fixture.py", """
        import jax.numpy as jnp
        def upcast_batch(x):
            return x.astype(jnp.float32)
    """, "fixture.py", """
        import torch
        def upcast_batch(x):
            return x.to(torch.float32)
    """, []),
    ("dlt010_waiver", "fixture.py", """
        import jax.numpy as jnp
        def quantized_fallback(x):
            return x.astype(jnp.float32)  # lint: disable=DLT010 (fp32 boundary)
    """, "fixture.py", """
        import torch
        def quantized_fallback(x):
            return x.to(torch.float32)  # lint: disable=DLT010 (fp32 boundary)
    """, []),
    # DLT011 widened: torch's global RNG in data paths
    ("dlt011_torch_global_rng", "deeplearning4j_tpu/datasets/fixture.py", """
        import numpy as np
        def shard_order(n):
            np.random.seed(0)
            return np.random.permutation(n)
    """, "deeplearning4j_tpu/datasets/fixture.py", """
        import torch
        def shard_order(n):
            torch.manual_seed(0)
            return torch.randperm(n)
    """, ["DLT011", "DLT011"]),
    ("dlt011_torch_generator", "deeplearning4j_tpu/datasets/fixture.py", """
        import numpy as np
        def shard_order(seed, n):
            return np.random.default_rng(seed).permutation(n)
    """, "deeplearning4j_tpu/datasets/fixture.py", """
        import torch
        def shard_order(gen, n):
            return torch.randperm(n, generator=gen)
    """, []),
    # DLT012: autotune-time work in hot paths
    ("dlt012_meta_estimate_in_serving", SERV, """
        import jax
        def dispatch(step, args):
            compiled = step.lower(*args).compile()
            return compiled(*args)
    """, SERV, """
        import torch
        def dispatch(step, args):
            compiled = step(*[a.to(torch.device("meta")) for a in args])
            return step(*args)
    """, ["DLT012"]),
    ("dlt012_cost_in_parallel", "deeplearning4j_tpu/parallel/fixture.py", """
        def serve_batch(compiled, x):
            cost = compiled.cost_analysis()
            return compiled(x), cost
    """, "deeplearning4j_tpu/parallel/fixture.py", """
        def serve_batch(compiled, x):
            cost = compiled.step_cost(x)
            return compiled(x), cost
    """, ["DLT012"]),
    ("dlt012_two_on_one_line", "deeplearning4j_tpu/nn/multilayer.py", """
        def _fit_batch(self, step, ds):
            ma = step.lower(ds).compile().memory_analysis()
            return ma
    """, "deeplearning4j_tpu/nn/multilayer.py", """
        def _fit_batch(self, step, ds):
            ma = plan_memory(step, ds.to(device="meta"))
            return ma
    """, ["DLT012", "DLT012"]),
    ("dlt012_kernel_build", "deeplearning4j_tpu/serving/fixture.py", """
        def dispatch(step, args):
            compiled = step.lower(*args).compile()
            return compiled(*args)
    """, "deeplearning4j_tpu/serving/fixture.py", """
        def dispatch(step, args):
            compiled = _build.build(["int4_dot"])
            return step(*args)
    """, ["DLT012"]),
    ("dlt012_owners_out_of_scope_autotune", "deeplearning4j_tpu/perf/autotune.py", """
        def estimate(step, args):
            return step.lower(*args).compile().cost_analysis()
    """, "deeplearning4j_tpu/perf/autotune.py", """
        def estimate(step, args):
            return step_cost(step, [a.to(device="meta") for a in args])
    """, []),
    ("dlt012_owners_out_of_scope_memory", "deeplearning4j_tpu/nn/memory.py", """
        def estimate(step, args):
            return step.lower(*args).compile().cost_analysis()
    """, "deeplearning4j_tpu/nn/memory.py", """
        def estimate(step, args):
            return step_cost(step, [a.to(device="meta") for a in args])
    """, []),
    ("dlt012_regex_compile", SERV, """
        import re
        def route(pattern, path):
            return re.compile(pattern).match(path)
    """, SERV, """
        import re
        def route(pattern, path):
            return re.compile(pattern).match(path)
    """, []),
    ("dlt012_waiver", SERV, """
        def dispatch(step, args):
            return step.lower(*args).compile()  # lint: disable=DLT012 (warmup path, offline)
    """, SERV, """
        def dispatch(step, args):
            return step_cost(step, args)  # lint: disable=DLT012 (warmup path, offline)
    """, []),
    # DLT013: host work in retrieval scoring
    ("dlt013_np_in_root", RETR, """
        import functools
        import jax
        import jax.numpy as jnp
        import numpy as np
        @functools.partial(jax.jit, static_argnames=("k",))
        def _rank_all(q, vecs, k):
            d = jnp.matmul(q, vecs.T)
            return np.argsort(d)
    """, RETR, """
        import functools
        import torch
        import torch.nn.functional as F
        import numpy as np
        @functools.partial(torch.compile, dynamic=False)
        def _rank_all(q, vecs, k):
            d = torch.matmul(q, vecs.T)
            return np.argsort(d)
    """, ["DLT013"]),
    ("dlt013_item_and_readback_in_score", RETR, """
        import jax
        import jax.numpy as jnp
        def score_cells(q, cells):
            d = jnp.einsum("bd,cd->bc", q, cells)
            best = d.min().item()
            return jax.device_get(d), best
    """, RETR, """
        import torch
        import torch.nn.functional as F
        def score_cells(q, cells):
            d = torch.einsum("bd,cd->bc", q, cells)
            best = d.min().item()
            return d.cpu(), best
    """, ["DLT013", "DLT013"]),
    ("dlt013_scalar_cast_and_implicit_syncs", RETR, """
        import jax
        import jax.numpy as jnp
        def topk_cells(q, cells):
            d = jnp.einsum("bd,cd->bc", q, cells)
            best = d.min().item()
            return jax.device_get(d), best
    """, RETR, """
        import torch
        import torch.nn.functional as F
        def topk_cells(q, cells):
            d = torch.einsum("bd,cd->bc", q, cells)
            best = float(d.min())
            return torch.unique(d), best
    """, ["DLT013", "DLT013"]),
    ("dlt013_host_wrapper_and_builders", RETR, """
        import numpy as np
        import jax.numpy as jnp
        def search(self, queries, k):
            q = np.asarray(queries, np.float32)
            dist, idx = self._search_device(jnp.asarray(q), k)
            return np.asarray(idx), np.asarray(dist)
        def build_table(vecs):
            return np.clip(np.rint(vecs), -127, 127)
    """, RETR, """
        import numpy as np
        import torch
        def search(self, queries, k):
            q = np.asarray(queries, np.float32)
            dist, idx = self._search_device(torch.from_numpy(q), k)
            return idx.cpu().numpy(), dist.cpu().numpy()
        def build_table(vecs):
            return np.clip(np.rint(vecs), -127, 127)
    """, []),
    ("dlt013_out_of_scope_path", "deeplearning4j_tpu/perf/thing.py", """
        import jax.numpy as jnp
        import numpy as np
        def score_stuff(x):
            return np.asarray(jnp.abs(x))
    """, "deeplearning4j_tpu/perf/thing.py", """
        import torch
        import numpy as np
        def score_stuff(x):
            return torch.abs(x).cpu()
    """, []),
    ("dlt013_waiver", RETR, """
        import jax.numpy as jnp
        import numpy as np
        def probe_debug(q):
            v = jnp.abs(q)
            return np.asarray(v)  # lint: disable=DLT013 (debug dump)
    """, RETR, """
        import torch
        import numpy as np
        def probe_debug(q):
            v = torch.abs(q)
            return v.cpu()  # lint: disable=DLT013 (debug dump)
    """, []),
    # DLT014: host work in packed-code functions
    ("dlt014_np_unpack", PACK, """
        import jax.numpy as jnp
        import numpy as np
        def unpack_nibbles_fast(packed, d):
            lo = (np.left_shift(packed, 4) >> 4)
            return jnp.asarray(lo[..., :d])
    """, PACK, """
        import torch
        import numpy as np
        def unpack_nibbles_fast(packed, d):
            lo = (np.left_shift(packed, 4) >> 4)
            return torch.as_tensor(lo[..., :d])
    """, ["DLT014"]),
    ("dlt014_item_in_adc", PQ, """
        import jax.numpy as jnp
        def adc_accumulate(lut, codes):
            d2 = jnp.take(lut, codes, axis=1)
            return d2.min().item()
    """, PQ, """
        import torch
        def adc_accumulate(lut, codes):
            d2 = torch.take_along_dim(lut, codes, dim=1)
            return d2.min().item()
    """, ["DLT014"]),
    ("dlt014_readback_in_pq_score", PQ, """
        import jax
        import jax.numpy as jnp
        def score_pq_debug(lut):
            return jax.device_get(jnp.sum(lut))
    """, PQ, """
        import torch
        import torch.nn.functional as F
        def score_pq_debug(lut):
            return torch.sum(lut).tolist()
    """, ["DLT013", "DLT014"]),
    ("dlt014_pure_host_packer", PACK, """
        import numpy as np
        def pack_nibbles(codes):
            u = codes.astype(np.uint8)
            return ((u[..., 0::2] & 0xF) | ((u[..., 1::2] & 0xF) << 4)
                    ).view(np.int8)
    """, PACK, """
        import numpy as np
        def pack_nibbles(codes):
            u = codes.astype(np.uint8)
            return ((u[..., 0::2] & 0xF) | ((u[..., 1::2] & 0xF) << 4)
                    ).view(np.int8)
    """, []),
    ("dlt014_out_of_scope_path", "deeplearning4j_tpu/perf/thing.py", """
        import jax.numpy as jnp
        import numpy as np
        def pack_records(x):
            return np.asarray(jnp.abs(x))
    """, "deeplearning4j_tpu/perf/thing.py", """
        import torch
        import numpy as np
        def pack_records(x):
            return torch.abs(x).numpy()
    """, []),
    ("dlt014_waiver", PACK, """
        import jax.numpy as jnp
        import numpy as np
        def unpack_probe(packed):
            v = jnp.asarray(packed)
            return np.asarray(v)  # lint: disable=DLT014 (test helper)
    """, PACK, """
        import torch
        import numpy as np
        def unpack_probe(packed):
            v = torch.as_tensor(packed)
            return v.numpy()  # lint: disable=DLT014 (test helper)
    """, []),
    # DLT015: JAX's Pallas kernel bodies; the port's launch functions
    ("dlt015_host_work_in_launch", KERN, """
        import numpy as np
        import jax
        def _bad_kernel(x_ref, o_ref):
            v = np.sum(x_ref[...])
            s = x_ref[0, 0].item()
            h = jax.device_get(x_ref[...])
            o_ref[...] = v
    """, PKERN, """
        import numpy as np
        import torch
        def bad_launch(x, out):
            v = np.sum(x.shape)
            s = x[0, 0].item()
            h = x.cpu()
            global launches
    """, ["DLT015"] * 3),
    ("dlt015_fallback_to_plain", KERN, """
        def _bad_kernel(x_ref, o_ref):
            s = 4
            while s > 0:
                s -= 1
            for row in x_ref[...]:
                pass
            if x_ref:
                o_ref[...] = x_ref[...]
    """, PKERN, """
        def launch(x, out):
            global launches
            try:
                fn = _kernel()
                n = x.nonzero()
            except OSError:
                return launch_plain(x.cpu(), out)
            launches += 1
    """, ["DLT015"] * 3),
    ("dlt015_vararg_launch", KERN, """
        import numpy as np
        def accumulate(n_rows, *refs):
            z_ref, o_ref = refs
            o_ref[...] = np.asarray(z_ref[...])
    """, PKERN, """
        import numpy as np
        def launch_accumulate(n_rows, *tensors):
            global launches
            tensors[1].copy_(torch.from_numpy(np.asarray(tensors[0])))
    """, ["DLT015"]),
    ("dlt015_clean_launch", KERN, """
        def _clean_kernel(m_count, has_res, x_ref, o_ref):
            acc = x_ref[...] * 0
            for m in range(m_count):
                acc = acc + x_ref[...]
            if has_res:
                acc = acc + 1
            o_ref[...] = acc
    """, PKERN, """
        def launch_clean(m_count, has_res, x, out):
            global launches
            for m in range(m_count):
                out.add_(x)
            if has_res:
                out.add_(1)
            launches += 1
    """, []),
    ("dlt015_non_launch_function", KERN, """
        import numpy as np
        def build_lut(codebooks):
            return np.einsum("mkd,mkd->mk", codebooks, codebooks)
    """, PKERN, """
        import numpy as np
        def build_lut(codebooks):
            return np.einsum("mkd,mkd->mk", codebooks, codebooks)
    """, []),
    ("dlt015_out_of_scope_path", KERN.replace("perf/pallas", "retrieval"), """
        import numpy as np
        def _bad_kernel(x_ref, o_ref):
            o_ref[...] = np.sum(x_ref[...])
    """, "deeplearning4j_tpu_torch/retrieval/fixture.py", """
        import numpy as np
        def _bad_launch(x, out):
            global launches
            out.copy_(np.sum(x.shape))
    """, []),
    ("dlt015_waiver", KERN, """
        import numpy as np
        def _probe_kernel(x_ref, o_ref):
            o_ref[...] = np.sum(x_ref[...])  # lint: disable=DLT015 (interpret-only debug probe)
    """, PKERN, """
        import numpy as np
        def _probe_launch(x, out):
            out.fill_(np.sum(x.shape))  # lint: disable=DLT015 (shape arithmetic)
            global launches
    """, []),
    # DLT020: host transfers inside a decode / sampling loop
    ("dlt020_np_and_item_in_token_loop", DEC, """
        import jax.numpy as jnp
        import numpy as np
        def decode_step(params, carry, toks):
            outs = []
            for t in range(50):
                carry = jnp.tanh(carry @ params)
                outs.append(np.asarray(carry))
                tid = carry.sum().item()
            return outs
    """, DEC, """
        import torch
        import numpy as np
        def decode_step(params, carry, toks):
            outs = []
            for t in range(50):
                carry = torch.tanh(carry @ params)
                outs.append(np.asarray(carry))
                tid = carry.sum().item()
            return outs
    """, ["DLT020", "DLT020"]),
    ("dlt020_readback_in_while", "deeplearning4j_tpu/nn/multilayer.py", """
        import jax
        import jax.numpy as jnp
        def sample_stream(logits, n):
            while n > 0:
                tok = jax.device_get(jnp.argmax(logits))
                n -= 1
    """, "deeplearning4j_tpu/nn/multilayer.py", """
        import torch
        import torch.nn.functional as F
        def sample_stream(logits, n):
            while n > 0:
                tok = int(torch.argmax(logits))
                n -= 1
    """, ["DLT020"]),
    ("dlt020_bulk_read_outside_loop", DEC, """
        import jax.numpy as jnp
        import numpy as np
        def decode_step(params, carry):
            for t in range(50):
                carry = jnp.tanh(carry @ params)
            return np.asarray(carry)
    """, DEC, """
        import torch
        import numpy as np
        def decode_step(params, carry):
            for t in range(50):
                carry = torch.tanh(carry @ params)
            return carry.cpu().numpy()
    """, []),
    ("dlt020_non_decode_function", DEC, """
        import jax.numpy as jnp
        import numpy as np
        def pad_batch(params, rows):
            out = []
            for r in rows:
                out.append(np.asarray(jnp.asarray(r)))
            return out
    """, DEC, """
        import torch
        import numpy as np
        def pad_batch(params, rows):
            out = []
            for r in rows:
                out.append(torch.as_tensor(r).cpu())
            return out
    """, []),
    ("dlt020_pure_host_helper", DEC, """
        import numpy as np
        def decode_events(blocks):
            out = []
            for b in blocks:
                out.append(np.frombuffer(b, dtype=np.uint8))
            return out
    """, DEC, """
        import numpy as np
        def decode_events(blocks):
            out = []
            for b in blocks:
                out.append(np.frombuffer(b, dtype=np.uint8))
            return out
    """, []),
    ("dlt020_out_of_scope_path", "deeplearning4j_tpu/datasets/iterator.py", """
        import jax.numpy as jnp
        import numpy as np
        def decode_step(params, carry, toks):
            for t in range(50):
                carry = jnp.tanh(carry @ params)
                toks.append(np.asarray(carry))
    """, "deeplearning4j_tpu/datasets/iterator.py", """
        import torch
        import numpy as np
        def decode_step(params, carry, toks):
            for t in range(50):
                carry = torch.tanh(carry @ params)
                toks.append(carry.cpu())
    """, []),
    ("dlt020_waiver", DEC, """
        import jax.numpy as jnp
        import numpy as np
        def decode_debug(params, carry):
            for t in range(3):
                carry = jnp.tanh(carry @ params)
                print(np.asarray(carry))  # lint: disable=DLT020
            return carry
    """, DEC, """
        import torch
        import numpy as np
        def decode_debug(params, carry):
            for t in range(3):
                carry = torch.tanh(carry @ params)
                print(carry.cpu())  # lint: disable=DLT020
            return carry
    """, []),
    ("file_waiver", "fixture.py", """
        # lint: disable-file=DLT001 (import-time table is intentional)
        import jax.numpy as jnp
        TABLE = jnp.arange(1024)
    """, "fixture.py", """
        # lint: disable-file=DLT001 (import-time table is intentional)
        import torch
        TABLE = torch.arange(1024)
    """, []),
]


@pytest.mark.parametrize("name,jpath,jsrc,ppath,psrc,want", DEVICE_CASES,
                         ids=[c[0] for c in DEVICE_CASES])
def test_device_rule_translation(name, jpath, jsrc, ppath, psrc, want):
    """The torch translation is flagged exactly where the JAX linter flags
    the original (the same rules on the same lines); negatives by neither."""
    jax_found = _found(jlint.lint_file(jpath, src=textwrap.dedent(jsrc)))
    port_found = _found(plint.lint_file(_port(ppath), src=textwrap.dedent(psrc)))
    assert port_found == jax_found
    assert sorted(r for r, _ in port_found) == sorted(want)


# --------------------------------------------------------------------------
# call graph: the same resolved facts over the JAX package's fixtures
# --------------------------------------------------------------------------
def _graph_facts(g):
    edges = {q: sorted((e.callee, e.lineno, e.held) for e in es)
             for q, es in g.edges.items()}
    locks = {q: sorted((a.lock, a.lineno, a.held, a.via) for a in acqs)
             for q, acqs in g.lock_acqs.items()}
    threads = {q: ([(t.lineno, t.daemon, t.target, t.assigned, t.direct)
                    for t in fn.thread_starts], sorted(fn.joins), sorted(fn.daemon_sets))
               for q, fn in g.functions.items()}
    return edges, locks, threads, sorted(g.thread_targets)


@pytest.mark.parametrize("fixture", ["hostwork_pkg", "lockpair_pkg", "leaky_threads.py"])
def test_callgraph_facts_match_the_jax_package(fixture):
    path = os.path.join(JFIX, fixture)
    jg, pg = jcg.build_graph([path]), pcg.build_graph([path])
    assert sorted(pg.functions) == sorted(jg.functions)
    assert _graph_facts(pg) == _graph_facts(jg)
    assert any(pg.edges.values()) or any(fn.thread_starts for fn in pg.functions.values())


def test_callgraph_find_path_and_cache():
    path = os.path.join(JFIX, "lockpair_pkg")
    g = pcg.build_graph([path])
    chain = g.find_path("lockpair_pkg.journal.Journal.rotate",
                        "lockpair_pkg.state.StateManager.checkpoint")
    assert chain == jcg.build_graph([path]).find_path(
        "lockpair_pkg.journal.Journal.rotate", "lockpair_pkg.state.StateManager.checkpoint")
    assert pcg.build_graph([path]) is g  # cached on the content hashes
    pcg.clear_cache()
    assert pcg.build_graph([path]) is not g


def test_step_roots_of_the_translated_fixture():
    g = pcg.build_graph([os.path.join(PFIX, "hostwork_pkg")])
    assert g.entries() == ["hostwork_pkg.entry.predict"]
    chains = g.reachable_from_entries()
    assert chains["hostwork_pkg.hostutil.drift_scale"] == (
        "hostwork_pkg.entry.predict", "hostwork_pkg.stats.standardize",
        "hostwork_pkg.hostutil.drift_scale")


# --------------------------------------------------------------------------
# DLT017 through the torch translation of hostwork_pkg
# --------------------------------------------------------------------------
def _dlt017(path):
    return [v for v in plint.lint_paths([path]) if v.rule == "DLT017"]


def test_dlt017_at_the_jax_fixture_lines_with_chains():
    jax_lines = sorted(v.line for v in jlint.lint_paths([os.path.join(JFIX, "hostwork_pkg")])
                       if v.rule == "DLT017")
    found = _dlt017(os.path.join(PFIX, "hostwork_pkg"))
    assert sorted(v.line for v in found) == jax_lines == [11, 12]
    chain = ("hostwork_pkg.entry.predict -> hostwork_pkg.stats.standardize"
             " -> hostwork_pkg.hostutil.drift_scale")
    for v in found:
        assert v.file.endswith(os.path.join("hostwork_pkg", "hostutil.py"))
        assert chain in v.message and "2 call hops" in v.message
    assert "torch.rand without generator=" in found[0].message
    assert "numpy.asarray" in found[1].message


def test_dlt017_sync_in_the_roots_own_body(tmp_path):
    """Eager torch runs a step root's body every step (a traced JAX body
    cannot sync at all): a sync there is DLT017's, a global-RNG draw there
    DLT002's."""
    (tmp_path / "step.py").write_text(textwrap.dedent("""
        import torch
        @torch.compile
        def step(x):
            noise = torch.rand(x.shape)
            return x + noise, x.max().item()
    """))
    found = [(v.rule, v.line) for v in plint.lint_paths([str(tmp_path)])]
    assert found == [("DLT002", 5), ("DLT017", 6)]
    assert ".step.step' —" in plint.lint_paths([str(tmp_path)])[1].message


def test_decode_dispatches_are_step_roots():
    """The decode engine hands its five dispatches to CompileWatch.wrap,
    as the JAX engine jits them, so a sync under its sampler is seen."""
    g = pcg.build_graph([os.path.join(REPO_ROOT, "deeplearning4j_tpu_torch", "serving",
                                      "decode.py")])
    want = [f"deeplearning4j_tpu_torch.serving.decode.DecodeEngine._{k}"
            for k in ("clear", "grow", "join", "prefill", "step")]
    assert [r for r in g.entries() if ".DecodeEngine." in r] == want
    assert "deeplearning4j_tpu_torch.serving.decode._sample_next" in \
        g.reachable_from_entries()


@pytest.mark.parametrize("root,draw,hit", [
    ("@torch.compile", "torch.rand(())", True),
    ("@torch.compile", "torch.rand((), generator=gen)", False),
    ("@torch.compile", "float(x.sum())", True),
    ("", "float(x.sum())", False),
], ids=["global_rng", "seeded", "sync", "no_root"])
def test_dlt017_roots_and_hazards(root, draw, hit, tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "entry.py").write_text(textwrap.dedent(f"""
        import torch
        from . import util
        {root}
        def step(x):
            return util.scale(x)
    """))
    (pkg / "util.py").write_text(textwrap.dedent(f"""
        import torch
        gen = torch.Generator()
        def scale(x):
            return x * {draw}
    """))
    assert bool(_dlt017(str(pkg))) == hit


def test_dlt017_waiver_suppresses_and_registers_live(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("")
    (pkg / "entry.py").write_text(textwrap.dedent("""
        import torch
        from . import util
        class Step(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                return util.scale(x)
    """))
    (pkg / "util.py").write_text(textwrap.dedent("""
        import torch
        def scale(x):
            return x * x.max().item()  # lint: disable=DLT017 (a deliberate host read)
    """))
    assert plint.lint_paths([str(pkg)]) == []
    assert plint.audit_waivers([str(pkg)]) == []
    assert [v.rule for v in plint.raw_findings([str(pkg)])] == ["DLT017"]


# --------------------------------------------------------------------------
# waiver audit
# --------------------------------------------------------------------------
@pytest.mark.parametrize("jsrc,psrc,rules,scope", [
    ("import jax.numpy as jnp\nTABLE = jnp.arange(4)  # lint: disable=DLT001 (tiny)\n"
     "def f():\n    return 1  # lint: disable=DLT003 (nothing fired)\n",
     "import torch\nTABLE = torch.arange(4)  # lint: disable=DLT001 (tiny)\n"
     "def f():\n    return 1  # lint: disable=DLT003 (nothing fired)\n", ("DLT003",), "inline"),
    ("# lint: disable-file=DLT008 (no queues any more)\ndef f():\n    return 1\n",
     "# lint: disable-file=DLT008 (no queues any more)\ndef f():\n    return 1\n",
     ("DLT008",), "file"),
], ids=["inline", "file"])
def test_stale_waivers_reported_like_the_jax_package(jsrc, psrc, rules, scope, tmp_path):
    found = []
    for linter, src in ((jlint, jsrc), (plint, psrc)):
        d = tmp_path / linter.__name__.split(".")[0]
        d.mkdir()
        (d / "mod.py").write_text(src)
        found.append([(s.line, s.rules, s.scope) for s in linter.audit_waivers([str(d)])])
    assert found[1] == found[0]
    assert [(r, sc) for _, r, sc in found[1]] == [(rules, scope)]


# --------------------------------------------------------------------------
# the port tree, and run_lint's contract
# --------------------------------------------------------------------------
def test_port_lints_clean_within_budget():
    """The port's surface (the package, chip_smoke.py, the repo-root tools
    that import torch or the port) lints clean; a cold run (summaries and
    call graph from scratch) stays under 60 s; a warm run from the
    content-hash caches is at least 5x faster with the same findings; no
    waiver is stale."""
    targets = plint.DEFAULT_TARGETS(REPO_ROOT)
    assert os.path.join(REPO_ROOT, "chip_smoke.py") in targets
    assert not any("deeplearning4j_tpu" + os.sep in t for t in targets)
    plint.clear_caches()
    t0 = time.perf_counter()
    violations = plint.lint_paths(targets)
    cold = time.perf_counter() - t0
    assert violations == [], "\n".join(str(v) for v in violations)
    t0 = time.perf_counter()
    assert plint.lint_paths(targets) == violations
    warm = time.perf_counter() - t0
    assert cold < 60.0, f"cold port lint took {cold:.1f}s"
    assert warm * 5 <= cold, f"warm {warm:.3f}s vs cold {cold:.3f}s"
    assert plint.audit_waivers(targets) == []


def _load_jax_run_lint():
    spec = importlib.util.spec_from_file_location(
        "jax_run_lint_under_test", os.path.join(REPO_ROOT, "tools", "run_lint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(capsys, jargs, pargs):
    """(rc, stdout) of the JAX tool and of the port's on their arguments."""
    out = []
    for main, args in ((_load_jax_run_lint().main, jargs), (prun.main, pargs)):
        rc = main(["run_lint.py"] + args)
        out.append((rc, capsys.readouterr().out))
    return out


def test_run_lint_json_rule_filter(capsys):
    fix = os.path.join(JFIX, "lockpair_pkg")
    (jrc, jout), (prc, pout) = _both(capsys, ["--json", "--rule", "DLT018", fix],
                                     ["--json", "--rule", "DLT018", fix])
    assert jrc == prc == 1
    assert json.loads(pout) == json.loads(jout)
    assert json.loads(pout)["violations"][0]["file"].endswith("journal.py")


def test_run_lint_json_carries_the_chain(capsys):
    (jrc, jout), (prc, pout) = _both(
        capsys, ["--json", "--rule", "DLT017", os.path.join(JFIX, "hostwork_pkg")],
        ["--json", "--rule", "DLT017", os.path.join(PFIX, "hostwork_pkg")])
    jp, pp = json.loads(jout), json.loads(pout)
    assert jrc == prc == 1
    assert set(pp) == set(jp) and pp["count"] == jp["count"] == 2
    assert [set(v) for v in pp["violations"]] == [set(v) for v in jp["violations"]]
    assert [v["chain"] for v in pp["violations"]] == [v["chain"] for v in jp["violations"]]


@pytest.mark.parametrize("args,rc", [
    (["--rule", "DLT001", "lockpair_pkg"], 0),
    (["--rule", "BOGUS"], 2),
    (["--frobnicate"], 2),
    (["--rule"], 2),
], ids=["filtered_to_zero", "bad_rule", "unknown_option", "rule_without_value"])
def test_run_lint_exit_codes(args, rc, capsys):
    args = [os.path.join(JFIX, a) if a == "lockpair_pkg" else a for a in args]
    (jrc, _), (prc, _) = _both(capsys, args, args)
    assert jrc == prc == rc


def test_run_lint_changed_only(capsys, monkeypatch):
    leaky = os.path.abspath(os.path.join(JFIX, "leaky_threads.py"))
    monkeypatch.setattr(prun, "_changed_files", lambda root: {leaky})
    assert prun.main(["run_lint.py", "--json", "--changed-only", JFIX]) == 1
    assert {v["rule"] for v in json.loads(capsys.readouterr().out)["violations"]} \
        == {"DLT019"}
    monkeypatch.setattr(prun, "_changed_files", lambda root: set())
    assert prun.main(["run_lint.py", "--changed-only", JFIX]) == 0
    capsys.readouterr()


def test_run_lint_audit_waivers(capsys, tmp_path):
    (tmp_path / "mod.py").write_text("def f():\n    return 1  # lint: disable=DLT003 (stale)\n")
    (jrc, jout), (prc, pout) = _both(capsys, ["--json", "--audit-waivers", str(tmp_path)],
                                     ["--json", "--audit-waivers", str(tmp_path)])
    assert jrc == prc == 1
    assert json.loads(pout) == json.loads(jout)
    assert json.loads(pout)["stale_waivers"][0]["rules"] == ["DLT003"]
