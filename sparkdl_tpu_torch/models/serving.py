"""Continuous-batching decode engine over a paged KV cache.

Counterpart of ``sparkdl_tpu/models/serving.py``'s
``ContinuousBatchingEngine`` on its paged path (``page_size > 0``):

- one pooled physical KV cache of ``n_pages`` pages shared by every
  slot through per-slot block tables; admission reserves a request's
  worst-case pages (prompt + budget) and queues it while the pool cannot
  cover them; a finished request's pages return to the pool; page 0 is
  the write-only dump for padding junk;
- admission prefills the prompt (padded to a power of two, floor 8)
  straight into the slot's pages and samples the first token at the
  true prompt end;
- decoding runs ``chunk``-token chunks over all slots at once: a Python
  loop over tokens whose state (tokens, positions, KV pool) stays on
  the device, with ONE host copy of the chunk's tokens and logprobs at
  its end — scheduling happens between chunks, as in the JAX engine;
- inactive slots keep stepping at a frozen position with every table
  entry pointed at the dump page, so every step has the same shape.

Not ported yet, and refused by name: the dense slot cache
(``page_size=0``), tensor parallelism (``mesh``, ``rules``), chunked
prefill (``prefill_chunk``), int4 (``quant="int4"``), kernel-mode
routing (``quant_kernel``), prefix sharing (``prefix_id``,
``register_prefix``), multi-LoRA (``adapter_id``) and telemetry.
"""

import dataclasses

import numpy as np
import torch

from sparkdl_tpu_torch.models.generate import sample_logits_with_lp
from sparkdl_tpu_torch.models.llama import Llama
from sparkdl_tpu_torch.models.quant import quantize_llama_params
from sparkdl_tpu_torch.ops._dispatch import resolve_device


def _hits_stop(tokens, stops):
    """True when any stop sequence is a suffix of ``tokens``."""
    return any(len(tokens) >= len(st)
               and tuple(tokens[-len(st):]) == st for st in stops)


@dataclasses.dataclass
class _Slot:
    req_id: int = -1
    active: bool = False
    remaining: int = 0
    tokens: list = dataclasses.field(default_factory=list)
    logprobs: list = dataclasses.field(default_factory=list)


class ContinuousBatchingEngine:
    """Greedy/temperature decoding over ``n_slots`` concurrent streams.

    Usage::

        eng = ContinuousBatchingEngine(model, model.state_dict(),
                                       n_slots=8, page_size=64,
                                       quant="int8")
        rid = eng.submit(prompt_tokens_1d, max_new_tokens=64)
        results = eng.run()          # {rid: np.ndarray of new tokens}

    ``model`` gives the config; ``params`` is a state dict with its keys
    (dense, or already int8 when ``model.cfg.quant`` is set). The
    engine's model takes those tensors as its weights, moved to
    ``device`` (default CUDA). ``quant="int8"`` quantizes a dense dict
    at construction. ``generator``: a ``torch.Generator`` on ``device``
    for temperature sampling (default: seeded with 0).

    ``stats`` afterwards holds steps, slot-step counts, prefill
    segments and the slot utilization ratio.
    """

    def __init__(self, model, params, *, n_slots=4, temperature=0.0,
                 eos_id=None, chunk=16, mesh=None, rules=None, page_size=0,
                 n_pages=None, prefill_chunk=0, top_k=0, top_p=1.0,
                 quant="", quant_kernel="", device=None, generator=None):
        for name, value in (("mesh", mesh), ("rules", rules),
                            ("prefill_chunk", prefill_chunk),
                            ("quant_kernel", quant_kernel)):
            if value:
                raise NotImplementedError(f"{name} is not ported yet")
        if quant == "int4":
            raise NotImplementedError("quant='int4' is not ported yet")
        if not page_size:
            raise NotImplementedError(
                "page_size=0 (the dense slot cache) is not ported yet; "
                "pass page_size > 0")
        self.device = resolve_device(device)
        cfg = model.cfg
        if quant:
            if quant != "int8":
                raise ValueError(
                    f"unknown quant mode {quant!r}; expected 'int8'")
            if cfg.quant:
                raise ValueError(
                    f"model is already quantized (cfg.quant={cfg.quant!r});"
                    " pass quant= only with a dense state dict")
            cfg = dataclasses.replace(cfg, quant=quant)
            params = quantize_llama_params(params, device=self.device)
        self.page_size = int(page_size)
        self._max_pages = -(-cfg.max_cache_len // self.page_size)
        n_slots = int(n_slots)
        n_pages = (int(n_pages) if n_pages is not None
                   else n_slots * self._max_pages + 1)
        self.cfg = dataclasses.replace(cfg, page_size=self.page_size,
                                       n_pages=n_pages, decode=True)
        self.n_slots = n_slots
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_id = eos_id
        self.chunk = int(chunk)
        self._generator = generator
        if generator is None and self.temperature > 0.0:
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(0)
        self._on_token = None  # streaming callback, set per run()
        self._model = Llama.from_params(self.cfg, params, self.device)
        self.params = params
        self._queue = []           # (rid, prompt, max_new)
        self._slots = [_Slot() for _ in range(self.n_slots)]
        self._results = {}
        self._stops = {}           # rid -> tuple of stop token tuples
        self._finish_reasons = {}  # rid -> "eos" | "length" | "stop"
        self.finish_reasons = {}   # last drained burst's reasons
        self._logprobs = {}        # rid -> finished logprob array
        self.logprobs = {}         # last drained burst's logprobs
        self._next_id = 0
        self.stats = {"steps": 0, "active_slot_steps": 0,
                      "total_slot_steps": 0, "prefill_segments": 0}
        # host-side page allocator: page 0 reserved as the junk dump
        self._free_pages = list(range(1, self.cfg.n_pages))
        self._tables = np.zeros((self.n_slots, self._max_pages), np.int32)
        self._slot_pages = [[] for _ in range(self.n_slots)]
        # device state: the pool (written in place), per-slot position
        # and last token
        self._cache = self._model.init_cache()
        self._pos = torch.zeros((self.n_slots,), dtype=torch.int32,
                                device=self.device)
        self._token = torch.zeros((self.n_slots,), dtype=torch.int32,
                                  device=self.device)

    # -- public API ---------------------------------------------------

    def register_prefix(self, prefix_tokens, adapter_id=0):
        raise NotImplementedError("register_prefix is not ported yet")

    def submit(self, prompt_tokens, max_new_tokens, prefix_id=None,
               adapter_id=0, stop=None):
        """Queue a request; returns its id. ``stop``: token-id sequences
        that end THIS request's generation when they appear (included in
        the output, like eos); finish causes land in
        :attr:`finish_reasons` after run()."""
        if prefix_id is not None:
            raise NotImplementedError("prefix_id is not ported yet")
        if adapter_id:
            raise NotImplementedError("adapter_id is not ported yet")
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        if not len(prompt):
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) + max_new_tokens > self.cfg.max_cache_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_cache_len "
                f"({self.cfg.max_cache_len})")
        rid = self._next_id
        self._next_id += 1
        if stop:
            seqs = tuple(
                tuple(int(t) for t in np.asarray(s).reshape(-1))
                for s in stop)
            if any(not s for s in seqs):
                raise ValueError("empty stop sequence")
            self._stops[rid] = seqs
        self._queue.append((rid, prompt, int(max_new_tokens)))
        return rid

    def run(self, progress=None, on_token=None):
        """Drain the queue; returns {req_id: generated tokens} for the
        requests finished during THIS drain.

        ``on_token(req_id, token)``: streaming callback for every
        accepted token in generation order (delivered per chunk).
        ``progress(engine)``: coarse per-iteration hook."""
        self._on_token = on_token
        try:
            with torch.no_grad():
                return self._run(progress)
        finally:
            # never retain the caller's closure past this run
            self._on_token = None

    def abort_requests(self):
        """Discard every queued and active request WITHOUT producing
        results (service fault recovery). Frees pool pages and
        deactivates slots; abandoned cache rows are junk that later
        admissions overwrite."""
        self._queue.clear()
        self._stops.clear()
        self._finish_reasons.clear()
        self._logprobs.clear()
        self._results.clear()
        for i, s in enumerate(self._slots):
            self._free_pages.extend(self._slot_pages[i])
            self._slot_pages[i] = []
            self._tables[i] = 0
            s.active = False
            s.req_id = -1
            s.remaining = 0
            s.tokens = []
            s.logprobs = []

    # -- scheduling ---------------------------------------------------

    def _sample(self, logits):
        return sample_logits_with_lp(
            logits, self._generator, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p)

    def _pages_needed(self, req):
        """Pages a request reserves: its worst case, prompt + budget."""
        _, prompt, max_new = req
        return -(-(len(prompt) + max_new) // self.page_size)

    def _try_admit_paged(self, slot_idx):
        """Allocate the queue head's worst-case pages, point the slot's
        block table at them and prefill straight into them. Returns
        False (request left at the queue head) when the pool cannot
        cover it yet — capacity admission control."""
        need = self._pages_needed(self._queue[0])
        if need > len(self._free_pages):
            return False
        rid, prompt, max_new = self._queue.pop(0)
        own = [self._free_pages.pop() for _ in range(need)]
        self._slot_pages[slot_idx] = own
        self._tables[slot_idx] = 0
        self._tables[slot_idx, :need] = own
        self._prefill_segment(slot_idx, prompt, rid, max_new)
        return True

    def _prefill_segment(self, slot_idx, tokens, rid, max_new):
        """Prefill ``tokens`` into the slot's pages and activate the
        slot with the sampled first token."""
        true_len = len(tokens)
        # power-of-two pad with a floor of 8; the cache-end cap cannot
        # undercut true_len because submit() bounds the prompt
        b = 8
        while b < true_len:
            b *= 2
        bucket = min(b, self.cfg.max_cache_len)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :true_len] = tokens
        dev = self.device
        logits = self._model(
            torch.as_tensor(padded, device=dev),
            torch.arange(bucket, device=dev)[None, :],
            torch.as_tensor(self._tables[slot_idx][None], device=dev),
            self._cache)
        tok, lp = self._sample(logits[:, true_len - 1])
        self.stats["prefill_segments"] += 1
        self._pos[slot_idx] = true_len
        self._token[slot_idx] = tok[0]
        self._activate_slot(slot_idx, rid, max_new, tok, lp)

    def _activate_slot(self, slot_idx, rid, max_new, tok, lp):
        """Admission epilogue: slot bookkeeping + the instant-finish
        check (first token is eos or a stop, or a one-token budget)."""
        s = self._slots[slot_idx]
        s.req_id, s.active = rid, True
        s.remaining = max_new - 1  # the prefill emitted token #1
        s.tokens = [int(tok[0])]
        s.logprobs = [float(lp[0])]
        if self._on_token is not None:
            self._on_token(rid, s.tokens[0])
        if self.eos_id is not None and s.tokens[0] == self.eos_id:
            self._finish(slot_idx, "eos")
        elif _hits_stop(s.tokens, self._stops.get(rid, ())):
            self._finish(slot_idx, "stop")
        elif s.remaining == 0:
            self._finish(slot_idx, "length")

    def _finish(self, slot_idx, reason="length"):
        s = self._slots[slot_idx]
        self._results[s.req_id] = np.asarray(s.tokens, np.int32)
        self._finish_reasons[s.req_id] = reason
        self._logprobs[s.req_id] = np.asarray(s.logprobs, np.float32)
        self._stops.pop(s.req_id, None)
        s.active = False
        s.tokens = []
        s.logprobs = []
        self._free_pages.extend(self._slot_pages[slot_idx])
        self._slot_pages[slot_idx] = []
        self._tables[slot_idx] = 0

    def _fill_slots(self):
        """Admit queued requests into free slots while the pool covers
        the queue head's worst case; returns the active mask."""
        for i, s in enumerate(self._slots):
            if not s.active and self._queue:
                if not self._try_admit_paged(i):
                    break
        return np.array([s.active for s in self._slots])

    def _deadend_check(self):
        """Nothing active: raise when the queue head can NEVER admit (a
        genuine pool shortfall) rather than spinning forever — an
        instantly finished admission also lands here, with its pages
        free again, and is not a dead end."""
        if self._queue:
            need = self._pages_needed(self._queue[0])
            if need > len(self._free_pages):
                raise RuntimeError(
                    f"paged pool exhausted: request needs {need} fresh "
                    f"pages, pool has {len(self._free_pages)} free and "
                    "nothing left to drain — raise n_pages")

    def _decode_chunk(self, active, tables, n):
        """``n`` decode steps over every slot; returns (tokens, logprobs)
        as (n, n_slots) host arrays — the chunk's one host copy."""
        toks = torch.empty((n, self.n_slots), dtype=torch.int32,
                           device=self.device)
        lps = torch.empty((n, self.n_slots), dtype=torch.float32,
                          device=self.device)
        token, pos = self._token, self._pos
        last = self.cfg.max_cache_len - 1
        for i in range(n):
            logits = self._model(token[:, None], pos[:, None], tables,
                                 self._cache)
            token, lp = self._sample(logits[:, -1])
            toks[i] = token
            lps[i] = lp
            # inactive slots freeze (their junk write lands in the dump
            # page); active ones clamp at the last cache row: a chunk
            # rounds up to a power of two, so a slot whose budget ends
            # mid-chunk keeps stepping and its overshoot is discarded
            pos = torch.where(active, torch.clamp(pos + 1, max=last), pos)
        self._token, self._pos = token, pos
        return toks.cpu().numpy(), lps.cpu().numpy()

    def _run(self, progress):
        while self._queue or any(s.active for s in self._slots):
            active = self._fill_slots()
            if not active.any():
                self._deadend_check()
                continue
            # chunk length: the soonest-finishing active slot's need,
            # rounded UP to a power of two and capped at ``chunk``
            need = min(s.remaining for s in self._slots if s.active)
            n = 1
            while n < need and n < self.chunk:
                n *= 2
            n = min(n, self.chunk)
            # non-active rows masked to the dump page
            tables = torch.as_tensor(
                np.where(active[:, None], self._tables, 0),
                device=self.device)
            toks, lps = self._decode_chunk(
                torch.as_tensor(active, device=self.device), tables, n)
            self.stats["steps"] += n
            self.stats["total_slot_steps"] += n * self.n_slots
            self.stats["active_slot_steps"] += int(active.sum()) * n
            for i, s in enumerate(self._slots):
                if s.active:
                    self._accept_tokens(i, toks[:, i], lps[:, i])
            if progress is not None:
                progress(self)
        return self._drain_results()

    def _accept_tokens(self, slot_idx, tokens, logprobs):
        """Append generated tokens to a slot (streaming callback, eos,
        stop and budget enforcement). Returns True when the slot
        finished — trailing tokens past the finish are discarded."""
        s = self._slots[slot_idx]
        stops = self._stops.get(s.req_id, ())
        for t, lp in zip(tokens, logprobs):
            s.tokens.append(int(t))
            s.logprobs.append(float(lp))
            s.remaining -= 1
            if self._on_token is not None:
                self._on_token(s.req_id, int(t))
            if self.eos_id is not None and int(t) == self.eos_id:
                self._finish(slot_idx, "eos")
                return True
            if stops and _hits_stop(s.tokens, stops):
                self._finish(slot_idx, "stop")
                return True
            if s.remaining == 0:
                self._finish(slot_idx, "length")
                return True
        return False

    def _drain_results(self):
        """Final stats + hand the burst's results to the caller."""
        self.stats["utilization"] = (
            self.stats["active_slot_steps"]
            / max(1, self.stats["total_slot_steps"]))
        self.finish_reasons = self._finish_reasons
        self._finish_reasons = {}
        self.logprobs = self._logprobs
        self._logprobs = {}
        out = self._results
        self._results = {}
        return out
