"""Generative decode tier: session state on the device, continuous session
batching, token streaming (counterpart of
``deeplearning4j_tpu/serving/decode.py``).

- **Session state on the device.** Every live session owns one slot of a
  state block on the card: the recurrent carries (h, c per LSTM layer)
  with leading axis = slot capacity, plus per-slot last token,
  temperature, top-k and active flag. Capacity is a pow2 **slot ladder**
  (min_slots, 2·min_slots, ... ≥ max_sessions); growth jumps to the next
  rung and never shrinks.
- **Continuous session batching.** One step advances every slot per
  dispatch. Sessions join and leave only at token boundaries, by writing
  their slot (join) or clearing its flag (clear), on the decode worker.
- **Sampling on the card.** Temperature / top-k sampling runs on the card
  (:func:`_sample_next`: the JAX package's top-k threshold, ``logits <
  kth`` masked and ties kept, then a Gumbel-max draw from an explicit
  ``torch.Generator`` on the card seeded from ``seed``; argmax where
  ``temperature <= 0``). Exactly one host read per dispatch
  (:func:`_host_read`, counted): the (S,) sampled-token vector of a step,
  or the first token of an admission.
- **Prefill buckets.** Prompts run through right-padded pow2 length
  buckets with a features mask; the LSTM mask semantics hold the carry
  through padded steps (``MultiLayerNetwork.decode_prefill_fn``). Longer
  prompts chunk through the largest bucket with the carry threaded — the
  same path re-prefills a session after a hot swap under
  ``policy="reprefill"``.
- **Dispatch shapes.** PyTorch compiles nothing, so where the JAX package
  counts compiles the engine counts the distinct dispatch shapes per kind
  (step, join, clear, grow at a rung; prefill at a bucket);
  ``stats()["new_shapes_after_warmup"]`` counts shapes first seen after
  :meth:`DecodeEngine.warmup`, which is 0 in steady state.
- **Checkpoint hot swap.** :meth:`DecodeEngine.start_hot_swap` polls a
  ``CheckpointManager``; a newer checkpoint is restored off the decode
  path, made whole on the card, and applied by the worker between
  dispatches — sessions keep their carries (``policy="carry"``) or are
  re-prefilled from prompt + generated under the new parameters
  (``policy="reprefill"``).

Only the decode worker mutates the session block; callers of
``open_session`` and the HTTP handlers see host values only.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel.inference import (QueueFullError, select_device,
                                                         tree_signature)

log = logging.getLogger(__name__)

__all__ = ["DecodeEngine", "DecodeSession", "SessionLimitError",
           "EngineStoppedError"]

_session_ids = itertools.count(1)


class SessionLimitError(QueueFullError):
    """Admission refused: every slot the engine may grow to is occupied.
    Subclasses QueueFullError so the server's 429 mapping applies."""


class EngineStoppedError(RuntimeError):
    """open_session() on a stopped or draining engine — maps to 503."""


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _sample_next(logits: torch.Tensor, temps: torch.Tensor, topks: torch.Tensor,
                 gen: torch.Generator) -> torch.Tensor:
    """Temperature / top-k sampling, one row per slot, on the logits'
    device: the top-k threshold from a descending sort (``logits < kth``
    masked to -inf, so ties with the k-th value stay), temperature scaling,
    then a Gumbel-max draw from ``gen`` (independent per row). ``topk <=
    0`` disables the cut; ``temp <= 0`` selects argmax (first index of the
    maximum). Returns int64 ids."""
    v = logits.shape[-1]
    desc = torch.sort(logits, dim=-1, descending=True).values
    k_idx = torch.clamp(torch.where(topks > 0, topks, torch.full_like(topks, v)), 1, v) - 1
    kth = desc.gather(1, k_idx[:, None].long())
    masked = torch.where(logits < kth, torch.full_like(logits, float("-inf")), logits)
    scaled = masked / torch.clamp_min(temps, 1e-6)[:, None]
    u = torch.rand(logits.shape, generator=gen, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temps > 0.0, sampled, greedy)


def _host_read(t: torch.Tensor) -> np.ndarray:
    """The ONE host transfer of a decode dispatch: the bulk (S,) sampled
    vector, or an admission's first token. Everything below this point in
    the delivery path is host numpy."""
    return t.cpu().numpy()


class DecodeSession:
    """One generative stream: admission parameters, the generated-id
    history, and a bounded event queue the transport drains.

    Events are dicts: ``{"type": "token", "id": int, "index": int,
    "text": str|None}``, ``{"type": "done", "reason": str, "tokens":
    int}`` or ``{"type": "error", "error": str, "message": str}``. A
    terminal event (done/error) is always the last one delivered."""

    def __init__(self, prompt_ids: Sequence[int], *, max_tokens: int,
                 temperature: float, top_k: int, eos_id: Optional[int],
                 engine: "DecodeEngine"):
        self.id = f"s{next(_session_ids)}"
        self.prompt_ids = [int(i) for i in prompt_ids]
        self.max_tokens = int(max_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.eos_id = eos_id if eos_id is None else int(eos_id)
        self.generated: List[int] = []
        self.opened_at = time.monotonic()
        self.first_token_at: Optional[float] = None
        self.token_times: List[float] = []
        self._last_token_at: Optional[float] = None
        self._engine = engine
        self._cancelled = False
        self._finished = False
        self._synthetic = False  # warm-up priming: excluded from metrics
        self.slot: Optional[int] = None
        # bounded: max_tokens token events + one terminal event
        self._events: "queue.Queue[dict]" = queue.Queue(maxsize=self.max_tokens + 8)

    # ------------------------------------------------------------- consumer
    def next_event(self, timeout_s: Optional[float] = None) -> Optional[dict]:
        """Blocking read of the next event; ``None`` means the timeout
        elapsed with the engine silent."""
        try:
            return self._events.get(timeout=timeout_s)
        except queue.Empty:
            return None

    def events(self, token_deadline_s: Optional[float] = None):
        """Iterate events until the terminal one. A token that misses
        ``token_deadline_s`` ends the iteration with a typed ``error``
        event (and cancels the session) — never a silent stall."""
        while True:
            ev = self.next_event(token_deadline_s)
            if ev is None:
                self.cancel()
                yield {"type": "error", "error": "token_deadline_expired",
                       "message": f"no token within {token_deadline_s}s"}
                return
            yield ev
            if ev["type"] in ("done", "error"):
                return

    def cancel(self):
        """Mark for retirement; the decode worker clears the slot at the
        next token boundary. Idempotent, callable from any thread."""
        self._cancelled = True
        self._engine._nudge()

    @property
    def finished(self) -> bool:
        return self._finished

    # ----------------------------------------------- engine-side delivery
    def _emit(self, ev: dict):
        try:
            self._events.put_nowait(ev)
        except queue.Full:  # consumer gone; retire via the cancel path
            self._cancelled = True

    def _finish(self, reason: str):
        self._finished = True
        self._emit({"type": "done", "reason": reason, "tokens": len(self.generated)})


class DecodeEngine:
    """Continuous-batching autoregressive decode over one recurrent
    ``MultiLayerNetwork`` on its device. One worker thread admits pending
    sessions, dispatches the step and delivers sampled tokens; all
    session-block mutation happens on it, so joins, leaves and swaps land
    exactly at token boundaries."""

    def __init__(self, net, *, max_sessions: int = 64, min_slots: int = 8,
                 prefill_buckets: Sequence[int] = (16, 64, 256),
                 seed: int = 0, vocab: Optional[Sequence[str]] = None):
        self._net = net
        self.device = net.device
        if net.params is None:
            net.init()
        self._step_fn = net.decode_step_fn()
        self._prefill_fn = net.decode_prefill_fn()
        self.vocab_size = net.decode_vocab_size()
        n_out = getattr(net.layers[-1], "n_out", None)
        if n_out is not None and int(n_out) != self.vocab_size:
            raise ValueError(
                f"closed-loop decode needs n_out == input vocab; got "
                f"n_out={n_out} vs vocab={self.vocab_size}")
        self.vocab = list(vocab) if vocab is not None else None
        self.max_sessions = int(max_sessions)
        min_slots = _pow2_at_least(min(min_slots, self.max_sessions))
        self._rungs: List[int] = []
        s = min_slots
        while True:
            self._rungs.append(s)
            if s >= self.max_sessions:
                break
            s *= 2
        self._buckets = sorted(_pow2_at_least(b) for b in prefill_buckets)
        self._params = net.params
        self._state = net.state
        with torch.no_grad():
            self._carry1 = net._zero_carries(1)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))

        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._cap_idx = 0
        with torch.no_grad():
            self._dstate = self._init_dstate(self._rungs[0])
        self._free: List[int] = list(range(self._rungs[0]))
        self._slots: Dict[int, DecodeSession] = {}
        self._pending: "deque[DecodeSession]" = deque()
        self._sessions: Dict[str, DecodeSession] = {}
        self._running = False
        self._draining = False
        self._warmed = False
        self._worker: Optional[threading.Thread] = None
        self._steps = 0
        self._admissions = 0
        self._host_reads = 0
        # distinct dispatch shapes per kind, and those first seen after
        # warmup() — the port's counterpart of the JAX engine's compiles
        self._shapes: Dict[str, set] = {k: set() for k in
                                        ("step", "join", "clear", "grow", "prefill")}
        self._new_shapes_after_warmup = 0
        # every dispatch through the network's CompileWatch under the JAX
        # engine's keys; what CompileWatch.wrap is handed is a step root of
        # the port's linter (analysis/lint.py), as the jitted programs are
        watch = net.compile_watch
        self._step = watch.wrap(self._step, "decode.step")
        self._join = watch.wrap(self._join, "decode.join")
        self._clear = watch.wrap(self._clear, "decode.clear")
        self._grow = watch.wrap(self._grow, "decode.grow")
        self._prefill = watch.wrap(self._prefill, "decode.prefill")

        # hot swap
        self._swap_cm = None
        self._swap_policy = "carry"
        self._swap_seen_step: Optional[int] = None
        self._pending_swap: Optional[Tuple[object, object, int]] = None
        self._swap_count = 0
        self._swap_thread: Optional[threading.Thread] = None
        self._swap_stop = threading.Event()
        self._init_metrics()

    # ------------------------------------------------------------- metrics
    def _init_metrics(self):
        from deeplearning4j_tpu_torch.obs.registry import get_registry
        reg = get_registry()
        self._m_active = reg.gauge(
            "decode_sessions_active", unit="sessions",
            help="live decode sessions holding a device slot")
        self._m_tokens = reg.counter(
            "decode_tokens_total", unit="tokens",
            help="tokens sampled and delivered across all decode sessions")
        self._m_steps = reg.counter(
            "decode_steps_total", unit="dispatches",
            help="batched decode step dispatches (all active slots "
                 "advance one token per dispatch)")
        self._m_ttft = reg.histogram(
            "decode_ttft_ms", unit="ms",
            help="time to first token: session open to first delivery")
        self._m_itl = reg.histogram(
            "decode_itl_ms", unit="ms",
            help="inter-token latency between consecutive deliveries "
                 "of one session")
        self._m_swaps = reg.counter(
            "decode_hot_swaps_total", unit="swaps",
            help="checkpoint hot-swaps applied at a token boundary")

    def _shape(self, kind: str, size: int):
        """Record one dispatch shape; count it when warm-up never ran it."""
        seen = self._shapes[kind]
        if size not in seen:
            seen.add(size)
            if self._warmed:
                self._new_shapes_after_warmup += 1

    # -------------------------------------------------------- device state
    def _init_dstate(self, cap: int):
        dev = self.device
        return (self._net._zero_carries(cap),
                torch.zeros(cap, dtype=torch.int64, device=dev),
                torch.ones(cap, dtype=torch.float32, device=dev),
                torch.zeros(cap, dtype=torch.int64, device=dev),
                torch.zeros(cap, dtype=torch.bool, device=dev))

    @property
    def capacity(self) -> int:
        return self._rungs[self._cap_idx]

    # ---------------------------------------------------------- dispatches
    def _step(self, params, state, dstate, gen):
        carries, tokens, temps, topks, active = dstate
        self._shape("step", int(tokens.shape[0]))
        logits, new_carries = self._step_fn(params, state, carries, tokens)
        nxt = _sample_next(logits, temps, topks, gen)
        return (new_carries, nxt, temps, topks, active), nxt

    def _join(self, dstate, slot: int, carry, token, temp: float, topk: int):
        carries, tokens, temps, topks, active = dstate
        self._shape("join", int(tokens.shape[0]))
        for dst, src in zip(carries, carry):
            for k in dst:
                dst[k][slot] = src[k][0]
        tokens[slot] = token
        temps[slot] = float(temp)
        topks[slot] = int(topk)
        active[slot] = True
        return dstate

    def _clear(self, dstate, slot: int):
        self._shape("clear", int(dstate[1].shape[0]))
        dstate[4][slot] = False
        return dstate

    def _grow(self, dstate):
        carries, tokens, temps, topks, active = dstate
        self._shape("grow", int(tokens.shape[0]))

        def pad(a):
            return torch.cat([a, torch.zeros_like(a)], dim=0)

        return ([{k: pad(v) for k, v in c.items()} for c in carries],
                pad(tokens), pad(temps), pad(topks), pad(active))

    def _prefill(self, params, state, ids: np.ndarray, length: int, carry,
                 temp: float, topk: int, gen):
        self._shape("prefill", int(ids.shape[1]))
        ids_t = torch.from_numpy(ids).to(self.device)
        last, new_carry = self._prefill_fn(params, state, ids_t, length, carry)
        t = torch.tensor([float(temp)], device=self.device)
        k = torch.tensor([int(topk)], device=self.device)
        tok = _sample_next(last, t, k, gen)[0]
        return new_carry, tok

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "DecodeEngine":
        with self._work:
            if self._running:
                return self
            self._running = True
        self._worker = threading.Thread(target=self._run_loop,
                                        name="decode-worker", daemon=True)
        self._worker.start()
        return self

    @torch.no_grad()
    def warmup(self):
        """Dispatch the whole slot ladder (step / join / clear at every
        rung, grow at every rung transition) and every prefill bucket on a
        scratch block, then run a synthetic priming wave through the live
        worker — max_sessions short sessions that grow the ladder to its
        top rung. Capacity then sits at the top rung, so every serve-time
        dispatch repeats a shape the warm-up ran. Priming sessions are
        excluded from the serving metrics."""
        select_device(self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        params, state = self._params, self._state
        carry, tok = self._carry1, None
        for b in self._buckets:
            carry, tok = self._prefill(params, state, np.zeros((1, b), np.int64), 1,
                                       self._carry1, 1.0, 0, gen)
        ds = self._init_dstate(self._rungs[0])
        for i, cap in enumerate(self._rungs):
            ds = self._join(ds, 0, carry, tok, 1.0, 0)
            ds, toks = self._step(params, state, ds, gen)
            ds = self._clear(ds, 0)
            if i + 1 < len(self._rungs):
                ds = self._grow(ds)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # priming wave: the live path end to end, worker thread included
        self.start()
        prime = []
        with self._work:
            if not self._draining:
                for _ in range(self.max_sessions):
                    sess = DecodeSession([0], max_tokens=2, temperature=1.0,
                                         top_k=2, eos_id=None, engine=self)
                    sess._synthetic = True
                    self._sessions[sess.id] = sess
                    self._pending.append(sess)
                    prime.append(sess)
                self._work.notify_all()
        for sess in prime:
            for _ in sess.events(token_deadline_s=120.0):
                pass
        with self._work:
            self._warmed = True
        return self

    def readiness(self) -> Tuple[bool, List[str]]:
        reasons = []
        if not self._warmed:
            reasons.append("decode slot ladder not warmed")
        if not self._running:
            reasons.append("decode worker not running")
        return (not reasons), reasons

    def stop(self, drain: bool = False, drain_timeout_s: float = 10.0):
        """Stop the worker. ``drain=True`` first refuses new sessions and
        waits (bounded) for active ones to finish; anything still live at
        the deadline gets a terminal error event."""
        with self._work:
            self._draining = True
            self._work.notify_all()
        if drain:
            deadline = time.monotonic() + drain_timeout_s
            with self._work:
                while (self._slots or self._pending) and time.monotonic() < deadline:
                    self._work.wait(min(0.05, max(0.0, deadline - time.monotonic())))
        with self._work:
            self._running = False
            self._work.notify_all()
            leftovers = list(self._slots.values()) + list(self._pending)
            self._slots.clear()
            self._pending.clear()
        for sess in leftovers:
            if not sess._finished:
                sess._finished = True
                sess._emit({"type": "error", "error": "engine_stopped",
                            "message": "decode engine stopped"})
        self._swap_stop.set()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
        if self._swap_thread is not None:
            self._swap_thread.join(timeout=5.0)
        self._m_active.set(0)

    # ------------------------------------------------------------ admission
    def open_session(self, prompt_ids: Sequence[int], *,
                     max_tokens: int = 64, temperature: float = 1.0,
                     top_k: int = 0, eos_id: Optional[int] = None
                     ) -> DecodeSession:
        """Admit a generative stream, or refuse: SessionLimitError (429)
        when every slot the ladder may grow to is held, EngineStoppedError
        (503) when stopping or draining. Admission itself happens on the
        decode worker at the next token boundary."""
        prompt_ids = list(prompt_ids)
        if not prompt_ids:
            raise ValueError("empty prompt: decode needs >= 1 prompt token")
        bad = [i for i in prompt_ids if not (0 <= int(i) < self.vocab_size)]
        if bad:
            raise ValueError(
                f"prompt ids out of range [0, {self.vocab_size}): {bad[:5]}")
        if max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        with self._work:
            if not self._running or self._draining:
                raise EngineStoppedError("decode engine is not accepting "
                                         "sessions (stopped or draining)")
            if len(self._sessions) >= self.max_sessions:
                raise SessionLimitError(f"all {self.max_sessions} decode sessions in use")
            sess = DecodeSession(prompt_ids, max_tokens=max_tokens,
                                 temperature=temperature, top_k=top_k,
                                 eos_id=eos_id, engine=self)
            self._sessions[sess.id] = sess
            self._pending.append(sess)
            self._work.notify_all()
        return sess

    def _nudge(self):
        with self._work:
            self._work.notify_all()

    # ----------------------------------------------------------- the worker
    def _run_loop(self):
        """Admit → step → deliver, forever. Every session-block mutation
        (join / clear / grow / swap) happens here, between steps."""
        select_device(self.device)
        with torch.no_grad():
            while True:
                with self._work:
                    if not self._running:
                        return
                    try:
                        if self._pending_swap is not None:
                            self._apply_swap_locked()
                        self._admit_pending_locked()
                    except Exception as e:
                        log.exception("decode admission failed; terminating sessions")
                        self._fail_all_locked(e)
                        return
                    if not self._slots:
                        self._work.wait(0.05)
                        continue
                    params, state, dstate = self._params, self._state, self._dstate
                    occupied = dict(self._slots)
                try:
                    dstate, toks_dev = self._step(params, state, dstate, self._gen)
                    toks = _host_read(toks_dev)
                except Exception as e:
                    log.exception("decode step failed; terminating sessions")
                    with self._work:
                        self._fail_all_locked(e)
                    return
                with self._work:
                    self._dstate = dstate
                    self._steps += 1
                    self._host_reads += 1
                    self._m_steps.inc()
                    self._deliver_locked(toks, occupied)

    def _admit_pending_locked(self):
        while self._pending:
            sess = self._pending[0]
            if sess._cancelled:
                self._pending.popleft()
                self._sessions.pop(sess.id, None)
                if not sess._finished:
                    sess._finish("cancelled")
                continue
            if not self._free:
                if self._cap_idx + 1 >= len(self._rungs):
                    break  # ladder maxed; the admission gate prevents this
                old = self.capacity
                self._dstate = self._grow(self._dstate)
                self._cap_idx += 1
                self._free.extend(range(old, self.capacity))
            self._pending.popleft()
            slot = self._free.pop()
            carry, first_tok = self._run_prefill(sess.prompt_ids, sess.temperature,
                                                 sess.top_k)
            self._dstate = self._join(self._dstate, slot, carry, first_tok,
                                      sess.temperature, sess.top_k)
            sess.slot = slot
            self._slots[slot] = sess
            self._m_active.set(len(self._slots))
            self._admissions += 1
            self._host_reads += 1
            self._deliver_one_locked(sess, int(_host_read(first_tok)))

    def _run_prefill(self, ids: List[int], temp: float, topk: int):
        """Right-padded bucketed prefill; prompts longer than the top bucket
        chunk through it with the carry threaded. Returns the batch-1 carry
        after the whole prompt and the sampled first token (on the device:
        no host read here)."""
        params, state = self._params, self._state
        carry = self._carry1
        top = self._buckets[-1]
        pos = 0
        tok = None
        while pos < len(ids):
            rem = len(ids) - pos
            if rem > top:
                n, bucket = top, top
            else:
                n = rem
                bucket = next(b for b in self._buckets if b >= rem)
            chunk = np.zeros((1, bucket), dtype=np.int64)
            chunk[0, :n] = ids[pos:pos + n]
            carry, tok = self._prefill(params, state, chunk, n, carry, temp, topk,
                                       self._gen)
            pos += n
        return carry, tok

    def _deliver_locked(self, toks: np.ndarray, occupied: Dict[int, DecodeSession]):
        for slot, sess in occupied.items():
            if sess._cancelled:
                self._retire_locked(sess, "cancelled")
                continue
            self._deliver_one_locked(sess, int(toks[slot]))

    def _deliver_one_locked(self, sess: DecodeSession, tok: int):
        now = time.monotonic()
        sess.generated.append(tok)
        sess.token_times.append(now)
        if sess.first_token_at is None:
            sess.first_token_at = now
            if not sess._synthetic:
                self._m_ttft.observe((now - sess.opened_at) * 1e3)
        elif sess._last_token_at is not None and not sess._synthetic:
            self._m_itl.observe((now - sess._last_token_at) * 1e3)
        sess._last_token_at = now
        if not sess._synthetic:
            self._m_tokens.inc()
        text = None
        if self.vocab is not None and 0 <= tok < len(self.vocab):
            text = self.vocab[tok]
        sess._emit({"type": "token", "id": tok,
                    "index": len(sess.generated) - 1, "text": text})
        if sess.eos_id is not None and tok == sess.eos_id:
            self._retire_locked(sess, "eos")
        elif len(sess.generated) >= sess.max_tokens:
            self._retire_locked(sess, "max_tokens")

    def _retire_locked(self, sess: DecodeSession, reason: str):
        slot = sess.slot
        if slot is not None and self._slots.get(slot) is sess:
            self._dstate = self._clear(self._dstate, slot)
            del self._slots[slot]
            self._free.append(slot)
        sess.slot = None
        self._sessions.pop(sess.id, None)
        self._m_active.set(len(self._slots))
        if not sess._finished:
            sess._finish(reason)
        self._work.notify_all()

    def _fail_all_locked(self, err: Exception):
        self._running = False
        sessions = list(self._sessions.values())
        self._sessions.clear()
        self._slots.clear()
        self._pending.clear()
        for sess in sessions:
            sess._finished = True
            sess._emit({"type": "error", "error": "engine_failure",
                        "message": str(err)})
        self._work.notify_all()

    # ------------------------------------------------------------- hot swap
    def start_hot_swap(self, checkpoint_manager, poll_secs: Optional[float] = 5.0,
                       policy: str = "carry"):
        """Poll for newer checkpoints and apply them at a token boundary.
        ``policy="carry"``: sessions keep their carries across the swap.
        ``policy="reprefill"``: each live session's carry is rebuilt under
        the new params from prompt + generated history. ``poll_secs=None``
        starts no poller: call :meth:`poll_checkpoint` by hand."""
        if policy not in ("carry", "reprefill"):
            raise ValueError(f"unknown hot-swap policy {policy!r}")
        self._swap_cm = checkpoint_manager
        self._swap_policy = policy
        self._swap_seen_step = checkpoint_manager.latest_step()
        if poll_secs is not None:
            self._swap_thread = threading.Thread(
                target=self._swap_loop, args=(float(poll_secs),),
                name="decode-hot-swap", daemon=True)
            self._swap_thread.start()
        return self

    def _swap_loop(self, poll_secs: float):
        errors = 0
        while not self._swap_stop.wait(poll_secs * (1 + min(errors, 5))):
            try:
                self.poll_checkpoint()
                errors = 0
            except Exception:
                errors += 1
                log.exception("decode hot-swap poll failed (%d)", errors)

    def poll_checkpoint(self) -> bool:
        """One poll: restore a strictly newer checkpoint off the decode
        path, check that its tree matches, finish building it on the card,
        then hand it to the worker to swap between dispatches. Returns
        True when a swap was staged."""
        cm = self._swap_cm
        if cm is None:
            return False
        select_device(self.device)
        cm.refresh()
        refresh_err = getattr(cm, "last_refresh_error", None)
        if refresh_err is not None:
            raise refresh_err
        latest = cm.latest_step()
        if latest is None or (self._swap_seen_step is not None
                              and latest <= self._swap_seen_step):
            return False
        net = cm.restore_latest(load_updater=False)
        if net is None:
            return False
        # restore_latest may fall back past a torn newest entry to a
        # checkpoint at or before the one served — never downgrade
        restored_step = getattr(getattr(net, "_restored_from", None), "step", latest)
        if self._swap_seen_step is not None and restored_step <= self._swap_seen_step:
            return False
        if net.device != self.device:
            net = net.to(self.device)
        if tree_signature(net.params) != tree_signature(self._params):
            log.warning("hot-swap refused: checkpoint param structure changed")
            self._swap_seen_step = latest
            return False
        if self.device.type == "cuda":
            # built on this thread: finished before the worker reads it
            torch.cuda.synchronize(self.device)
        with self._work:
            self._pending_swap = (net.params, net.state, latest)
            self._swap_seen_step = latest
            self._work.notify_all()
        return True

    def _apply_swap_locked(self):
        params, state, ckpt_step = self._pending_swap
        self._pending_swap = None
        self._params, self._state = params, state
        self._swap_count += 1
        self._m_swaps.inc()
        log.info("decode hot-swap applied at step boundary (checkpoint "
                 "step %s, policy=%s, %d live sessions)", ckpt_step,
                 self._swap_policy, len(self._slots))
        if self._swap_policy != "reprefill":
            return
        for slot, sess in list(self._slots.items()):
            history = sess.prompt_ids + sess.generated[:-1]
            last = sess.generated[-1] if sess.generated else None
            if last is None:  # nothing delivered yet: a plain re-admit
                history, last = sess.prompt_ids, 0
            carry, _ = self._run_prefill(history, sess.temperature, sess.top_k)
            self._dstate = self._join(self._dstate, slot, carry,
                                      torch.tensor(last, device=self.device),
                                      sess.temperature, sess.top_k)

    # ---------------------------------------------------------------- stats
    @property
    def active_sessions(self) -> int:
        with self._lock:
            return len(self._slots)

    def stats(self) -> dict:
        with self._lock:
            return {
                "active": len(self._slots),
                "pending": len(self._pending),
                "capacity": self.capacity,
                "max_sessions": self.max_sessions,
                "steps": self._steps,
                "admissions": self._admissions,
                "host_reads": self._host_reads,
                "hot_swaps": self._swap_count,
                "warmed": self._warmed,
                "dispatch_shapes": {k: len(v) for k, v in self._shapes.items()},
                "new_shapes_after_warmup": self._new_shapes_after_warmup,
            }
