"""The port's generative decode tier against the JAX package's, on the CPU.

A small ``TextGenerationLSTM`` (vocabulary 16, two GravesLSTM(16)) built by
the JAX package crosses to the port through its JSON and
``params_from_jax``. Checked:

- ``decode_step_fn`` and the masked ``decode_prefill_fn`` against the full
  forward (and the JAX package's ``decode_step_fn``);
- ``DecodeEngine`` greedy tokens equal to the JAX ``DecodeEngine``'s, token
  for token, for several sessions at once, a prompt chunked past the top
  prefill bucket included, and to the port's sequential ``rnn_time_step``;
- the admission taxonomy, EOS, zero new dispatch shapes after warm-up and
  one host read per dispatch;
- ``"carry"`` and ``"reprefill"`` hot swaps mid-generation, against the
  sequential decode that swaps at the same token;
- ``:generate`` over HTTP (SSE and JSON) with the same status codes and
  ``reason`` tags as the JAX server's for the same bodies.

Tolerances: logits within 1e-5 absolute (torch and XLA sum the LSTM's
products in another order); greedy tokens exact.
"""

import http.client
import json
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.textgenlstm import TextGenerationLSTM as JaxTextGen
from deeplearning4j_tpu.serving.decode import DecodeEngine as JaxEngine
from deeplearning4j_tpu.serving.server import ModelServer as JaxServer

from deeplearning4j_tpu_torch.checkpoint import CheckpointManager
from deeplearning4j_tpu_torch.interop import conf_from_jax_json, params_from_jax
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving import (DecodeEngine, EngineStoppedError, ModelServer,
                                              SessionLimitError)

VOCAB = list("abcdefghijklmnop")
LOGIT_ATOL = 1e-5
PROMPTS = [[0, 1, 2], [5], [3, 3, 9, 14, 2, 7, 1, 0],
           [int(t) for t in np.random.default_rng(3).integers(0, 16, 23)]]


def _jax_net(seed=7):
    return JaxTextGen(total_unique_characters=len(VOCAB), units=16, seed=seed).init()


def _port_of(jnet):
    net = MultiLayerNetwork(conf_from_jax_json(jnet.conf.to_json()), device="cpu")
    net.params = params_from_jax([{k: np.asarray(v) for k, v in p.items()}
                                  for p in jnet.params], device="cpu")
    return net


def _one_hot(ids):
    x = np.zeros((1, len(ids), len(VOCAB)), np.float32)
    x[0, np.arange(len(ids)), ids] = 1.0
    return x


def _sequential_greedy(net, prompt, n_tokens, swap_at=None, new_params=None,
                       reprefill=False):
    """Reference decode through ``rnn_time_step``: greedy, one token a call;
    with ``swap_at`` the parameters change after that many tokens, the
    carries kept (or rebuilt from prompt + history under the new ones)."""
    params = net.params
    net.rnn_clear_previous_state()
    out = net.rnn_time_step(_one_hot(prompt)[:, :, :])[:, -1]
    toks = [int(out[0].argmax())]
    while len(toks) < n_tokens:
        if swap_at is not None and len(toks) == swap_at:
            net.params = new_params
            if reprefill:
                net.rnn_clear_previous_state()
                net.rnn_time_step(_one_hot(prompt + toks[:-1]))
        out = net.rnn_time_step(_one_hot([toks[-1]])[:, 0])
        toks.append(int(out[0].argmax()))
    net.params = params
    net.rnn_clear_previous_state()
    return toks


def _tokens(sess, timeout=30.0):
    evs = list(sess.events(timeout))
    assert evs[-1]["type"] == "done", evs[-1]
    return [e["id"] for e in evs if e["type"] == "token"]


@pytest.fixture(scope="module")
def nets():
    jnet = _jax_net()
    return jnet, _port_of(jnet)


@pytest.fixture(scope="module")
def engines(nets):
    jnet, pnet = nets
    jeng = JaxEngine(jnet, max_sessions=4, min_slots=2, prefill_buckets=(4, 8), seed=1,
                     vocab=VOCAB)
    peng = DecodeEngine(pnet, max_sessions=4, min_slots=2, prefill_buckets=(4, 8), seed=1,
                        vocab=VOCAB)
    jeng.warmup()
    peng.warmup()
    yield jeng, peng
    jeng.stop()
    peng.stop()


def test_step_and_prefill_against_the_full_forward(nets):
    jnet, pnet = nets
    ids = [3, 1, 4, 1, 5, 9, 2, 6, 5]
    with torch.no_grad():
        _, full, _, _, _ = pnet._forward(pnet.params, pnet.state,
                                         torch.from_numpy(_one_hot(ids)), False)
        step = pnet.decode_step_fn()
        carries = pnet._zero_carries(1)
        for t, tok in enumerate(ids):
            logits, carries = step(pnet.params, pnet.state, carries, torch.tensor([tok]))
            np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(), atol=LOGIT_ATOL,
                                       rtol=0)
        padded = np.zeros((1, 16), np.int64)
        padded[0, :len(ids)] = ids
        last, pcarry = pnet.decode_prefill_fn()(pnet.params, pnet.state,
                                                torch.from_numpy(padded), len(ids),
                                                pnet._zero_carries(1))
    np.testing.assert_allclose(last.numpy(), full[:, -1].numpy(), atol=LOGIT_ATOL, rtol=0)
    for got, want in zip(pcarry, carries):
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=LOGIT_ATOL, rtol=0)
    jstep = jnet.decode_step_fn()
    jl, _ = jstep(jnet.params, jnet.state, jnet._zero_carries(1), np.array([ids[0]], np.int32))
    np.testing.assert_allclose(
        np.asarray(jl), step(pnet.params, pnet.state, pnet._zero_carries(1),
                             torch.tensor([ids[0]]))[0].numpy(), atol=LOGIT_ATOL, rtol=0)
    assert pnet.decode_vocab_size() == jnet.decode_vocab_size() == len(VOCAB)


def test_greedy_tokens_equal_the_jax_engine(engines, nets):
    jeng, peng = engines
    _, pnet = nets
    # all sessions at once: they share steps and the slot ladder grows
    jsess = [jeng.open_session(p, max_tokens=12, temperature=0.0) for p in PROMPTS]
    psess = [peng.open_session(p, max_tokens=12, temperature=0.0) for p in PROMPTS]
    for p, js, ps in zip(PROMPTS, jsess, psess):
        got, want = _tokens(ps), _tokens(js)
        assert got == want, (p, got, want)
        assert got == _sequential_greedy(pnet, p, 12)


def test_admission_taxonomy_and_eos(engines, nets):
    _, peng = engines
    _, pnet = nets
    for bad in (([], 4), ([999], 4), ([1], 0)):
        with pytest.raises(ValueError):
            peng.open_session(bad[0], max_tokens=bad[1])
    held = [peng.open_session([0], max_tokens=1_000_000) for _ in range(peng.max_sessions)]
    try:
        with pytest.raises(SessionLimitError):
            peng.open_session([1], max_tokens=4)
    finally:
        for s in held:
            s.cancel()
    for s in held:
        assert list(s.events(30.0))[-1] == {"type": "done", "reason": "cancelled",
                                            "tokens": len(s.generated)}
    want = _sequential_greedy(pnet, [0, 1, 2], 3)
    sess = peng.open_session([0, 1, 2], max_tokens=50, temperature=0.0, eos_id=want[2])
    evs = list(sess.events(30.0))
    assert evs[-1] == {"type": "done", "reason": "eos", "tokens": want.index(want[2]) + 1}
    stopped = DecodeEngine(pnet, max_sessions=2, min_slots=2, prefill_buckets=(4,)).start()
    stopped.stop()
    with pytest.raises(EngineStoppedError):
        stopped.open_session([1], max_tokens=4)


def test_no_new_dispatch_shapes_and_one_host_read_per_dispatch(engines):
    _, peng = engines
    st0 = peng.stats()
    sessions = [peng.open_session([i, i + 1], max_tokens=9, temperature=1.0, top_k=3)
                for i in range(4)]
    for s in sessions:
        assert len(_tokens(s)) == 9
    st = peng.stats()
    assert st["new_shapes_after_warmup"] == st0["new_shapes_after_warmup"] == 0
    assert st["host_reads"] == st["steps"] + st["admissions"]
    assert st["host_reads"] - st0["host_reads"] < 4 * 9
    assert st["dispatch_shapes"] == {"step": 2, "join": 2, "clear": 2, "grow": 1, "prefill": 2}


def _sampling(logits, temps, topks, seed):
    from deeplearning4j_tpu_torch.serving.decode import _sample_next
    gen = torch.Generator().manual_seed(seed)
    return _sample_next(torch.tensor(logits), torch.tensor(temps), torch.tensor(topks), gen)


def test_sampling_threshold_and_greedy():
    logits = np.array([[0.0, 3.0, 3.0, 1.0, -2.0]] * 4, np.float32)
    # greedy: first index of the maximum; top-1 with a tie keeps both
    assert _sampling(logits, [0.0] * 4, [0] * 4, 0).tolist() == [1, 1, 1, 1]
    draws = np.stack([_sampling(logits, [1.0] * 4, [1, 2, 3, 0], s).numpy()
                      for s in range(200)])
    assert set(draws[:, 0]) == {1, 2} and set(draws[:, 1]) == {1, 2}
    assert set(draws[:, 2]) <= {1, 2, 3} and 3 in draws[:, 2]
    assert set(draws[:, 3]) >= {0, 1, 2, 3}


def _wait(pred, what, timeout=30.0):
    end = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < end, f"timed out waiting for {what}"
        time.sleep(0.002)


@pytest.mark.parametrize("policy", ["carry", "reprefill"])
def test_hot_swap_mid_generation(tmp_path, policy):
    net = _port_of(_jax_net())
    cm = CheckpointManager(str(tmp_path / "ckpt"), device="cpu", async_write=False)
    cm.save(net)
    eng = DecodeEngine(net, max_sessions=2, min_slots=2, prefill_buckets=(4,), seed=0)
    eng.warmup()
    eng.start_hot_swap(cm, poll_secs=None, policy=policy)
    prompt = [1, 2, 3]
    try:
        # a stream that cannot end before the swap lands; cut 40 tokens past it
        sess = eng.open_session(prompt, max_tokens=1_000_000, temperature=0.0)
        _wait(lambda: len(sess.generated) >= 5, "tokens before the swap")
        newer = _port_of(_jax_net(seed=99))
        newer.iteration = 100
        cm.save(newer)
        assert eng.poll_checkpoint() is True
        _wait(lambda: eng.stats()["hot_swaps"] == 1, "the swap at a token boundary")
        n = len(sess.generated) + 40
        _wait(lambda: len(sess.generated) >= n, "tokens after the swap")
        sess.cancel()
        assert list(sess.events(30.0))[-1]["type"] == "done" and not eng.stats()["active"]
        toks = sess.generated[:n]
        assert eng.poll_checkpoint() is False
    finally:
        eng.stop()
        cm.close()
    # the swap landed at some token boundary s: the tokens are the
    # sequential decode that swaps there
    ref = _port_of(_jax_net())
    before = _sequential_greedy(ref, prompt, n)
    assert toks != before
    first = next(i for i in range(n) if toks[i] != before[i])
    matches = [s for s in range(max(1, first - 8), first + 1)
               if _sequential_greedy(ref, prompt, n, swap_at=s,
                                     new_params=newer.params,
                                     reprefill=policy == "reprefill") == toks]
    assert matches, f"no swap point reproduces the {policy} tokens"


# ------------------------------------------------------------------ HTTP
def _post(srv, path, body, timeout=30.0):
    c = http.client.HTTPConnection(srv.bind_address, srv.port, timeout=timeout)
    c.request("POST", path, body=json.dumps(body).encode())
    r = c.getresponse()
    data, headers = r.read(), dict(r.getheaders())
    c.close()
    return r.status, headers, data


def _sse_events(raw: str):
    out = []
    for block in raw.strip().split("\n\n"):
        lines = dict(ln.split(": ", 1) for ln in block.split("\n"))
        out.append((lines["event"], json.loads(lines["data"])))
    return out


def _generate_scenario(srv, eng):
    """The same bodies against one server: [(label, status, reason, retry)]
    and the payloads."""
    rows, out = [], {}
    path = "/v1/models/char:generate"

    def rec(label, res):
        code, headers, data = res
        try:
            body = json.loads(data)
        except ValueError:
            body = _sse_events(data.decode())
        reason = body.get("reason") if isinstance(body, dict) else None
        rows.append((label, code, reason, "Retry-After" in headers))
        out[label] = body

    rec("json", _post(srv, path, {"prompt": "abc", "max_tokens": 6, "temperature": 0.0,
                                  "stream": False}))
    rec("sse", _post(srv, path, {"prompt_ids": [0, 1, 2], "max_tokens": 6,
                                 "temperature": 0.0}))
    rec("eos", _post(srv, path, {"prompt_ids": [0, 1, 2], "max_tokens": 6, "temperature": 0.0,
                                 "eos_id": out["json"]["token_ids"][1], "stream": False}))
    rec("unknown", _post(srv, "/v1/models/nope:generate", {"prompt_ids": [1]}))
    rec("empty_body", _post(srv, path, {}))
    rec("bad_char", _post(srv, path, {"prompt": "a!z", "max_tokens": 4}))
    rec("bad_max_tokens", _post(srv, path, {"prompt_ids": [1], "max_tokens": 0}))
    rec("bad_temperature", _post(srv, path, {"prompt_ids": [1], "temperature": -1}))
    rec("bad_id", _post(srv, path, {"prompt_ids": [99]}))
    rec("empty_prompt", _post(srv, path, {"prompt_ids": []}))
    held = [eng.open_session([0], max_tokens=1_000_000) for _ in range(eng.max_sessions)]
    try:
        rec("shed", _post(srv, path, {"prompt_ids": [1], "max_tokens": 4}))
    finally:
        for s in held:
            s.cancel()
    for s in held:
        list(s.events(30.0))
    rec("ttft_deadline", _post(srv, path, {"prompt_ids": [1], "max_tokens": 4,
                                           "deadline_ms": 0.001, "stream": False}))
    srv.drain(timeout_s=5.0)
    try:
        rec("draining", _post(srv, path, {"prompt_ids": [1], "max_tokens": 4}))
    finally:
        srv.undrain()
    return rows, out


def test_generate_route_matches_the_jax_server(engines, nets):
    jeng, peng = engines
    _, pnet = nets
    results = []
    for cls, eng in ((JaxServer, jeng), (ModelServer, peng)):
        srv = cls()
        srv.add_generator("char", eng, default_deadline_ms=10_000.0)
        srv.start(warmup=False)
        try:
            results.append(_generate_scenario(srv, eng))
        finally:
            srv.stop(drain=True, drain_timeout_s=10.0)
    (jrows, jout), (prows, pout) = results
    assert prows == jrows
    codes = {label: (code, reason) for label, code, reason, _ in prows}
    assert codes == {"json": (200, "max_tokens"), "sse": (200, None), "eos": (200, "eos"),
                     "unknown": (404, "unknown_model"), "empty_body": (400, "bad_request"),
                     "bad_char": (400, "bad_request"), "bad_max_tokens": (400, "bad_request"),
                     "bad_temperature": (400, "bad_request"), "bad_id": (400, "bad_request"),
                     "empty_prompt": (400, "bad_request"), "shed": (429, "shed"),
                     "ttft_deadline": (504, "deadline_expired"),
                     "draining": (503, "draining")}
    want = _sequential_greedy(pnet, [0, 1, 2], 6)
    assert pout["json"]["token_ids"] == jout["json"]["token_ids"] == want
    assert pout["json"]["text"] == "".join(VOCAB[t] for t in want)
    kinds = [k for k, _ in pout["sse"]]
    assert kinds[0] == "meta" and kinds[-1] == "done"
    assert [d["id"] for k, d in pout["sse"] if k == "token"] == want
    assert [k for k, _ in jout["sse"]] == kinds
    assert pout["eos"]["token_ids"] == jout["eos"]["token_ids"] == want[:want.index(want[1]) + 1]
    for label in ("bad_char", "bad_max_tokens", "bad_id", "empty_prompt"):
        assert pout[label]["error"] == jout[label]["error"], label
