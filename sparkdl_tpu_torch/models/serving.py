"""Continuous-batching decode engines over a paged KV cache or a dense
slot cache, and the speculative engine over them.

Counterpart of ``sparkdl_tpu/models/serving.py``
(``ContinuousBatchingEngine``, ``SpeculativeBatchingEngine``):

- paged (``page_size > 0``): one pooled physical KV cache of
  ``n_pages`` pages shared by every slot through per-slot block tables;
  admission reserves a request's worst-case pages (prompt + budget) and
  queues it while the pool cannot cover them; a finished request's
  pages return to the pool; page 0 is the write-only dump for padding
  junk;
- dense slot cache (``page_size=0``): each slot owns ``max_cache_len``
  rows; admission prefills the prompt straight into the slot's rows
  (a slot-mapped prefill: the rows past its position, an earlier
  request's or padding, stay hidden by position);
- admission prefills the prompt (padded to a power of two, floor 8)
  and samples the first token at the true prompt end; with
  ``prefill_chunk`` (paged only) a longer prompt prefills in segments
  of that many tokens, one segment per staged slot per scheduling
  iteration, interleaved with decode chunks (a prefill at a logical
  start offset: positions ``start + arange(bucket)``);
- a registered prefix (``register_prefix``) is prefilled once: paged,
  into pool pages that a request extending it (``submit(prefix_id=...)``)
  shares read-only through its block table, with a copy of the partial
  boundary page (its suffix writes land there); dense, into rows that
  are copied into the slot at admission; either way only the suffix is
  prefilled;
- multi-LoRA (a model with ``cfg.multi_lora``): ``submit(adapter_id=)``
  selects a request's adapter, and every forward carries each slot's;
  a prefix is bound to the adapter it was registered under (its K/V
  went through that adapter's projections);
- decoding runs ``chunk``-token chunks over all slots at once: a Python
  loop over tokens whose state (tokens, positions, KV cache) stays on
  the device, with ONE host copy of the chunk's tokens and logprobs at
  its end — scheduling happens between chunks, as in the JAX engine;
- inactive slots keep stepping at a frozen position (paged: with every
  table entry pointed at the dump page), so every step has the same
  shape;
- :class:`SpeculativeBatchingEngine`: a draft proposes ``k`` tokens a
  slot, one target forward verifies them, and each slot accepts its
  longest agreeing prefix plus the target's next token (greedy), or
  runs distribution-exact rejection sampling (temperature > 0). The
  JAX round program becomes :meth:`~SpeculativeBatchingEngine._round`.

Weights: dense, or weight-only int8 or int4 (``quant=``).

Tensor-parallel serving (``mesh=``, ``rules=``): one engine a rank of a
port gang, every rank making the same calls in the same order. The
engine builds a tensor-parallel model from the whole state dict (this
rank keeps its slice, ``models.llama``), its caches hold this rank's kv
heads, and the paged decode runs through
:func:`~sparkdl_tpu_torch.ops.paged_attention.paged_attention_decode_sharded`.
The ranks of a ``model`` group take the same host decisions (admission,
eos, stops, budgets) because each sampled token, with its logprob, is
broadcast from the group's first rank once a decode step and once a
prefill.

ZeRO-3 serving (a ``mesh`` whose ``fsdp`` axis is > 1, alone or with
``model``): each rank stores its ``fsdp`` block of the weights and every
forward gathers each block's whole before it runs (``models.llama``),
under ``no_grad`` in prefill and decode alike. Slots are not split over
``fsdp``, as in the JAX engine, whose cache splits only kv heads over
``model``: every ``fsdp`` rank decodes every slot, and each sampled
token is broadcast over ``model`` and then over ``fsdp``, so every rank
of the mesh takes the same host decisions.

``telemetry``: an object with the JAX engine's hooks
(``request_admitted(rid)``, ``request_pages(rid, pages)`` when it has
one, ``admission_deferred(reason)``, ``decode_chunk(active, n_slots,
n_tokens, free_pages=, n_pages=)``), each called behind one ``is not
None`` test; None by default.

Not ported yet, and refused by name: kernel-mode routing
(``quant_kernel``).
"""

import dataclasses

import numpy as np
import torch

from sparkdl_tpu_torch.models.generate import (
    restrict_logits,
    sample_logits_with_lp,
)
from sparkdl_tpu_torch.models.llama import DenseKVCache, Llama
from sparkdl_tpu_torch.models.quant import quantize_llama_params
from sparkdl_tpu_torch.ops._dispatch import resolve_device
from sparkdl_tpu_torch.ops.paged_attention import (
    paged_attention_decode_sharded,
)


def _hits_stop(tokens, stops):
    """True when any stop sequence is a suffix of ``tokens``."""
    return any(len(tokens) >= len(st)
               and tuple(tokens[-len(st):]) == st for st in stops)


def _bucket(n, cap):
    """Prefill length for ``n`` tokens: a power of two with a floor of 8,
    capped at ``cap`` (the cache rows left after the start offset)."""
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


def _slot_prefill(model, cache, slot, tokens, start, adapter_ids=None):
    """Prefill ``tokens`` into row ``slot`` of a dense slot cache at
    positions ``start + arange(bucket)`` (a slot-mapped forward over a
    view of that row: the writes land in ``cache`` itself); returns the
    logits at the last true token (1, vocab). Padding junk lands past
    the true end, where the position mask hides it until it is
    overwritten."""
    dev = cache.k.device
    true_len = len(tokens)
    bucket = _bucket(true_len, model.cfg.max_cache_len - start)
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :true_len] = tokens
    view = DenseKVCache(cache.k[:, slot:slot + 1], cache.v[:, slot:slot + 1])
    logits = model(torch.as_tensor(padded, device=dev),
                   start + torch.arange(bucket, device=dev)[None, :],
                   cache=view, adapter_ids=adapter_ids)
    return logits[:, true_len - 1]


def _prefix_rows(model, prefix, adapter_ids=None):
    """A prefix's K/V rows in a dense model: prefilled into a batch-1
    cache, of which rows ``0..len(prefix)-1`` are kept as (k, v), each
    (n_layers, len(prefix), Hkv, D)."""
    one = model.init_cache(batch=1)
    _slot_prefill(model, one, 0, prefix, 0, adapter_ids)
    n = len(prefix)
    return one.k[:, 0, :n].clone(), one.v[:, 0, :n].clone()


def _copy_rows(cache, slot, rows):
    """Copy a prefix's (k, v) rows into the first rows of ``slot``."""
    k, v = rows
    cache.k[:, slot, :k.shape[1]] = k
    cache.v[:, slot, :v.shape[1]] = v


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
                                       quant="int4", prefill_chunk=256)
        rid = eng.submit(prompt_tokens_1d, max_new_tokens=64)
        results = eng.run()          # {rid: np.ndarray of new tokens}

    ``model`` gives the config; ``params`` is a state dict with its keys
    (dense, or already quantized when ``model.cfg.quant`` is set; with
    ``cfg.multi_lora``, stacked adapters from
    :func:`~sparkdl_tpu_torch.models.lora.stack_lora_adapters`). The
    engine's model takes those tensors as its weights, moved to
    ``device`` (default CUDA). ``quant="int8"`` or ``"int4"`` quantizes
    a dense dict at construction (int4 with ``cfg.quant_group`` rows a
    scale). ``page_size`` > 0 pools the KV cache in pages (``n_pages``,
    by default the dense capacity plus the dump page); 0 keeps a dense
    slot cache. ``prefill_chunk`` > 0 (paged only): prompts (or
    suffixes) longer than this prefill in segments interleaved with
    decode chunks, bounding the decode stall one admission causes to one
    segment. ``generator``: a ``torch.Generator`` on ``device`` for
    temperature sampling (default: seeded with 0).

    ``stats`` afterwards holds steps, slot-step counts, prefill
    segments (paged), prefix tokens not prefilled again and the slot
    utilization ratio.
    """

    def __init__(self, model, params, *, n_slots=4, temperature=0.0,
                 eos_id=None, chunk=16, mesh=None, rules=None, page_size=0,
                 n_pages=None, prefill_chunk=0, top_k=0, top_p=1.0,
                 quant="", quant_kernel="", device=None, generator=None):
        if quant_kernel:
            raise NotImplementedError("quant_kernel is not ported yet")
        if mesh is not None:
            axis_sizes = dict(mesh.shape)
            missing = {"model", "fsdp"} - set(axis_sizes)
            if missing:
                raise ValueError(
                    f"TP serving needs mesh axes 'model' and 'fsdp' "
                    f"(missing {sorted(missing)}); build the mesh with "
                    "sparkdl_tpu_torch.parallel.mesh.make_mesh")
            if device is None:
                device = mesh.device
        self.device = resolve_device(device)
        self.mesh = mesh
        cfg = model.cfg
        if quant:
            if quant not in ("int8", "int4"):
                raise ValueError(
                    f"unknown quant mode {quant!r}; expected 'int8' or "
                    "'int4'")
            if cfg.quant:
                raise ValueError(
                    f"model is already quantized (cfg.quant={cfg.quant!r});"
                    " pass quant= only with a dense state dict")
            # replace() re-runs __post_init__: quant excludes LoRA and
            # multi-LoRA
            cfg = dataclasses.replace(cfg, quant=quant)
            params = quantize_llama_params(
                params, bits=8 if quant == "int8" else 4,
                group=cfg.quant_group, device=self.device)
        self.page_size = int(page_size)
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk must be >= 0, got {self.prefill_chunk}")
        if self.prefill_chunk and not self.page_size:
            raise ValueError(
                "prefill_chunk requires the paged cache (page_size>0): the "
                "dense slot cache has no per-slot write path for partial "
                "prompts")
        self._prefilling = {}  # slot -> staged chunked-prefill state
        n_slots = int(n_slots)
        if self.page_size:
            self._max_pages = -(-cfg.max_cache_len // self.page_size)
            n_pages = (int(n_pages) if n_pages is not None
                       else n_slots * self._max_pages + 1)
        else:
            self._max_pages, n_pages = 0, 0
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
        paged_fn = None
        if mesh is not None and self.page_size:
            paged_fn = paged_attention_decode_sharded(
                mesh, axis_name="model", n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads)
        self._model = Llama.from_params(self.cfg, params, self.device,
                                        mesh=mesh, rules=rules,
                                        paged_attention_fn=paged_fn)
        # under tensor parallelism or ZeRO-3 this rank's slice (the
        # model's own tensors): the whole dict is the caller's to free
        self.params = (params if self._model.mesh is None
                       else self._model.state_dict())
        self._queue = []     # (rid, prompt, max_new, prefix_id, adapter_id)
        self._prefixes = {}  # prefix_id -> (tokens, pool pages | dense
                             #   (k, v) rows, adapter_id)
        self._slots = [_Slot() for _ in range(self.n_slots)]
        self._results = {}
        self._stops = {}           # rid -> tuple of stop token tuples
        self._finish_reasons = {}  # rid -> "eos" | "length" | "stop"
        self.finish_reasons = {}   # last drained burst's reasons
        self._logprobs = {}        # rid -> finished logprob array
        self.logprobs = {}         # last drained burst's logprobs
        self._next_id = 0
        self.stats = {"steps": 0, "active_slot_steps": 0,
                      "total_slot_steps": 0, "prefill_segments": 0,
                      "prefill_tokens_saved": 0}
        # request-level hooks (the fleet's _WorkerTelemetry); None keeps
        # each hook site at one test
        self.telemetry = None
        if self.page_size:
            # host-side page allocator: page 0 reserved as the junk dump
            self._free_pages = list(range(1, self.cfg.n_pages))
            self._tables = np.zeros((self.n_slots, self._max_pages),
                                    np.int32)
            self._slot_pages = [[] for _ in range(self.n_slots)]
            self._cache = self._model.init_cache()
        else:
            self._cache = self._model.init_cache(batch=self.n_slots)
        # device state: the cache (written in place), per-slot position
        # and last token; host: each slot's adapter
        self._pos = torch.zeros((self.n_slots,), dtype=torch.int32,
                                device=self.device)
        self._token = torch.zeros((self.n_slots,), dtype=torch.int32,
                                  device=self.device)
        self._adapter_ids = np.zeros((self.n_slots,), np.int32)

    # -- public API ---------------------------------------------------

    def _adapter_arg(self, adapter_id):
        """adapter_ids of a batch-1 forward: None on a single-adapter
        engine."""
        if not self.cfg.multi_lora:
            return None
        return torch.tensor([adapter_id], device=self.device)

    def _check_adapter(self, adapter_id):
        if self.cfg.multi_lora:
            if not 0 <= adapter_id < self.cfg.multi_lora:
                raise ValueError(
                    f"adapter_id {adapter_id} outside the stacked range "
                    f"[0, {self.cfg.multi_lora})")
        elif adapter_id:
            raise ValueError("adapter_id requires a multi_lora model "
                             "(LlamaConfig.multi_lora > 0)")

    def register_prefix(self, prefix_tokens, adapter_id=0):
        """Prefill a shared prompt PREFIX (a system prompt) once and keep
        its K/V; returns its ``prefix_id``. A request submitted with it
        prefills only its suffix: paged, it shares the prefix's full
        pages read-only and gets a copy of the partial boundary page;
        dense, the prefix rows are copied into its slot. The K/V are
        adapter-specific on a multi-LoRA engine (k_proj and v_proj carry
        the adapter), so the prefix is bound to ``adapter_id`` and only
        requests of that adapter may use it."""
        self._check_adapter(adapter_id)
        prefix = np.asarray(prefix_tokens, np.int32).reshape(-1)
        if not len(prefix):
            raise ValueError("empty prefix")
        # < (not <=): a prefix filling the whole cache leaves no room
        # for even a one-token suffix, so it could never be used
        if len(prefix) >= self.cfg.max_cache_len:
            raise ValueError(
                f"prefix ({len(prefix)}) must be shorter than "
                f"max_cache_len ({self.cfg.max_cache_len})")
        pid = f"prefix-{len(self._prefixes)}"
        with torch.no_grad():
            if not self.page_size:
                rows = _prefix_rows(self._model, prefix,
                                    self._adapter_arg(adapter_id))
                self._prefixes[pid] = (prefix, rows, adapter_id)
                return pid
            need = -(-len(prefix) // self.page_size)
            if need > len(self._free_pages):
                raise RuntimeError(
                    f"paged pool exhausted registering prefix: needs {need}"
                    f" pages, {len(self._free_pages)} free")
            pages = [self._free_pages.pop() for _ in range(need)]
            table = np.zeros((self._max_pages,), np.int32)
            table[:need] = pages
            self._prefill(table, prefix, 0, len(prefix), adapter_id)
        self._prefixes[pid] = (prefix, pages, adapter_id)
        return pid

    def copy_pages(self, src_pages, dst_pages):
        """Copy physical pages ``src -> dst`` of every layer's K and V
        pool in place (a shared prefix's partial boundary page becomes
        the slot's own: its suffix writes land there)."""
        dev = self.device
        src = torch.as_tensor(np.asarray(src_pages, np.int64), device=dev)
        dst = torch.as_tensor(np.asarray(dst_pages, np.int64), device=dev)
        for pool in (self._cache.k, self._cache.v):
            pool[:, dst] = pool[:, src]

    def submit(self, prompt_tokens, max_new_tokens, prefix_id=None,
               adapter_id=0, stop=None):
        """Queue a request; returns its id. ``prefix_id`` (from
        :meth:`register_prefix`): the prompt must START with that prefix
        and extend it by at least one token. ``adapter_id`` selects the
        request's LoRA adapter on a multi-LoRA engine. ``stop``:
        token-id sequences that end THIS request's generation when they
        appear (included in the output, like eos); finish causes land in
        :attr:`finish_reasons` after run()."""
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        self._check_adapter(adapter_id)
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
        if prefix_id is not None:
            if prefix_id not in self._prefixes:
                raise ValueError(
                    f"unknown prefix_id {prefix_id!r}; call "
                    "register_prefix first")
            prefix, _, pfx_adapter = self._prefixes[prefix_id]
            if self.cfg.multi_lora and pfx_adapter != adapter_id:
                raise ValueError(
                    f"prefix {prefix_id} is bound to adapter {pfx_adapter};"
                    f" request uses {adapter_id} — cached K/V rows are "
                    "adapter-specific")
            if (len(prompt) <= len(prefix)
                    or not np.array_equal(prompt[:len(prefix)], prefix)):
                raise ValueError(
                    f"prompt must extend the registered prefix "
                    f"{prefix_id} by at least one token")
        rid = self._next_id
        self._next_id += 1
        if stop:
            seqs = tuple(
                tuple(int(t) for t in np.asarray(s).reshape(-1))
                for s in stop)
            if any(not s for s in seqs):
                raise ValueError("empty stop sequence")
            self._stops[rid] = seqs
        self._queue.append((rid, prompt, int(max_new_tokens), prefix_id,
                            int(adapter_id)))
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

    def take_finished(self):
        """Hand over every request finished so far in the current
        ``run()``: ``{req_id: (tokens, finish reason, logprobs)}``. They
        leave what ``run()`` returns and its ``finish_reasons`` and
        ``logprobs``. A front-end calls it from ``run()``'s progress hook
        to answer each request as soon as it ends, not when the burst
        drains (the JAX engine has no such call: its front-end answers at
        the drain)."""
        out = {rid: (toks, self._finish_reasons.pop(rid),
                     self._logprobs.pop(rid))
               for rid, toks in self._results.items()}
        self._results = {}
        return out

    def abort_requests(self):
        """Discard every queued and active request WITHOUT producing
        results (service fault recovery). Frees pool pages and
        deactivates slots; abandoned cache rows are junk that later
        admissions overwrite."""
        self._queue.clear()
        self._prefilling.clear()
        self._stops.clear()
        self._finish_reasons.clear()
        self._logprobs.clear()
        self._results.clear()
        for i, s in enumerate(self._slots):
            if self.page_size:
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
        tok, lp = sample_logits_with_lp(
            logits, self._generator, temperature=self.temperature,
            top_k=self.top_k, top_p=self.top_p)
        mesh = self._model.mesh
        if mesh is None:
            return tok, lp
        # one broadcast from the model group's first rank, then one from
        # the fsdp group's: every rank of the mesh then takes the same
        # host decisions on the same tokens
        both = torch.stack([tok.to(torch.int32),
                            lp.to(torch.float32).view(torch.int32)])
        for axis in ("model", "fsdp"):
            if mesh.axis_size(axis) > 1:
                both = mesh.broadcast(both, axis)
        return both[0], both[1].view(torch.float32)

    def _worst_case_tokens(self, p_len, max_new):
        """Cache rows a request can ever touch: page reservation, the
        pool dead-end check and the HTTP frontend's request validation
        all size worst cases with this one hook (the speculative engine
        adds its k-token verify scratch)."""
        return p_len + max_new

    def _pages_needed(self, req):
        """Fresh pages a request reserves: its worst case minus the
        prefix pages it shares (the dead-end check must agree with
        admission, or it cries exhaustion over requests that would
        admit)."""
        _, prompt, max_new, prefix_id, _aid = req
        total = -(-self._worst_case_tokens(len(prompt), max_new)
                  // self.page_size)
        if prefix_id is not None:
            total -= len(self._prefixes[prefix_id][0]) // self.page_size
        return total

    def _admit(self, slot_idx):
        """Dense admission: copy a prefix's rows into the slot, prefill
        the prompt (or only its suffix) straight into the slot's rows
        and activate it with the sampled first token."""
        rid, prompt, max_new, prefix_id, adapter_id = self._queue.pop(0)
        if self.telemetry is not None:
            self.telemetry.request_admitted(rid)
        start = 0
        if prefix_id is not None:
            prefix, rows, _aid = self._prefixes[prefix_id]
            start = len(prefix)
            _copy_rows(self._cache, slot_idx, rows)
            self.stats["prefill_tokens_saved"] += start
        last = _slot_prefill(self._model, self._cache, slot_idx,
                             prompt[start:], start,
                             self._adapter_arg(adapter_id))
        tok, lp = self._sample(last)
        self._pos[slot_idx] = len(prompt)
        self._token[slot_idx] = tok[0]
        self._adapter_ids[slot_idx] = adapter_id
        self._activate_slot(slot_idx, rid, max_new, tok, lp)

    def _try_admit_paged(self, slot_idx):
        """Allocate the queue head's worst-case pages, point the slot's
        block table at them (a prefix's full pages shared, its partial
        boundary page copied into the slot's first own page) and prefill
        the prompt, or only its suffix, straight into them; with
        ``prefill_chunk`` a long suffix is staged instead, one segment
        an iteration. Returns False (request left at the queue head)
        when the pool cannot cover it yet — capacity admission
        control."""
        rid, prompt, max_new, prefix_id, adapter_id = self._queue[0]
        P = self.page_size
        total = -(-self._worst_case_tokens(len(prompt), max_new) // P)
        # no prefix = the empty-prefix case: nothing shared, start 0
        prefix, prefix_pages = np.zeros((0,), np.int32), []
        if prefix_id is not None:
            prefix, prefix_pages, _aid = self._prefixes[prefix_id]
        n_full = len(prefix) // P
        shared = prefix_pages[:n_full]
        need = total - len(shared)
        if need > len(self._free_pages):
            return False
        self._queue.pop(0)
        if self.telemetry is not None:
            self.telemetry.request_admitted(rid)
            # the request's worst-case pages; a telemetry without the
            # hook is served as well
            hook = getattr(self.telemetry, "request_pages", None)
            if hook is not None:
                hook(rid, total)
        own = [self._free_pages.pop() for _ in range(need)]
        self._slot_pages[slot_idx] = own
        self._tables[slot_idx] = 0
        self._tables[slot_idx, :total] = shared + own
        if len(prefix) % P:
            self.copy_pages([prefix_pages[n_full]], [own[0]])
        suffix, start = prompt[len(prefix):], len(prefix)
        self.stats["prefill_tokens_saved"] += len(prefix)
        if self.prefill_chunk and len(suffix) > self.prefill_chunk:
            # staged only: segments run one per scheduling iteration
            # (the first in this iteration's advance phase), and the
            # slot stays masked out of decode until the last one
            self._prefilling[slot_idx] = {
                "rid": rid, "suffix": suffix, "start": start, "done": 0,
                "max_new": max_new, "adapter_id": adapter_id}
            return True
        self._prefill_segment(slot_idx, suffix, start, len(suffix),
                              adapter_id, final=True, rid=rid,
                              max_new=max_new)
        return True

    def _prefill(self, table_row, tokens, start, true_len, adapter_id):
        """One paged prefill of ``tokens[:true_len]`` at logical
        positions ``start + arange(bucket)`` through ``table_row``;
        returns the logits at the last true token (1, vocab). Padding
        junk lands past the true end (overwritten later) or, beyond the
        table's pages, in the dump page."""
        bucket = _bucket(true_len, self.cfg.max_cache_len - start)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :true_len] = tokens[:true_len]
        dev = self.device
        logits = self._model(
            torch.as_tensor(padded, device=dev),
            start + torch.arange(bucket, device=dev)[None, :],
            torch.as_tensor(table_row[None], device=dev),
            self._cache, adapter_ids=self._adapter_arg(adapter_id))
        return logits[:, true_len - 1]

    def _prefill_segment(self, slot_idx, seg_tokens, start, true_len,
                         adapter_id, *, final, rid=None, max_new=None):
        """Prefill one segment into the slot's pages at offset
        ``start``; the FINAL segment's sampled token (the request's
        first) activates the slot."""
        last = self._prefill(self._tables[slot_idx], seg_tokens, start,
                             true_len, adapter_id)
        self.stats["prefill_segments"] += 1
        if final:
            tok, lp = self._sample(last)
            self._pos[slot_idx] = start + true_len
            self._token[slot_idx] = tok[0]
            self._adapter_ids[slot_idx] = adapter_id
            self._activate_slot(slot_idx, rid, max_new, tok, lp)

    def _advance_prefill(self, slot_idx):
        """One more segment for a mid-prefill slot; activates it on the
        last one."""
        st = self._prefilling[slot_idx]
        seg = min(self.prefill_chunk, len(st["suffix"]) - st["done"])
        final = st["done"] + seg == len(st["suffix"])
        self._prefill_segment(
            slot_idx, st["suffix"][st["done"]:st["done"] + seg],
            st["start"] + st["done"], seg, st["adapter_id"], final=final,
            rid=st["rid"], max_new=st["max_new"])
        st["done"] += seg
        if final:
            del self._prefilling[slot_idx]

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
        if self.page_size:
            self._free_pages.extend(self._slot_pages[slot_idx])
            self._slot_pages[slot_idx] = []
            self._tables[slot_idx] = 0

    def _fill_slots(self):
        """Admit queued requests into free slots (paged: while the pool
        covers the queue head's worst case), advance every staged
        chunked prefill by one segment, and return the active mask."""
        for i, s in enumerate(self._slots):
            if not s.active and i not in self._prefilling and self._queue:
                if not self.page_size:
                    self._admit(i)
                elif not self._try_admit_paged(i):
                    if self.telemetry is not None:
                        # requeued, not refused: the pool cannot cover
                        # the head's worst case yet
                        self.telemetry.admission_deferred("pool_exhausted")
                    break
        for i in list(self._prefilling):
            self._advance_prefill(i)
        return np.array([s.active for s in self._slots])

    def _observe_chunk(self, active_count, n_tokens):
        """The telemetry of one decode chunk (or speculation round), for
        both decode loops."""
        if self.telemetry is not None:
            self.telemetry.decode_chunk(
                active_count, self.n_slots, n_tokens,
                free_pages=(len(self._free_pages)
                            if self.page_size else None),
                n_pages=(self.cfg.n_pages if self.page_size else None))

    def _deadend_check(self):
        """Nothing active: raise when the queue head can NEVER admit (a
        genuine pool shortfall) rather than spinning forever — an
        instantly finished admission also lands here, with its pages
        free again, and is not a dead end; nor is a slot still in
        chunked prefill."""
        if self._queue and self.page_size and not self._prefilling:
            need = self._pages_needed(self._queue[0])
            if need > len(self._free_pages):
                raise RuntimeError(
                    f"paged pool exhausted: request needs {need} fresh "
                    f"pages, pool has {len(self._free_pages)} free and "
                    "nothing left to drain — raise n_pages")

    def _step_args(self, active):
        """The per-step block tables (paged: inactive rows masked to the
        dump page, so a staged prefill's written rows cannot be
        overwritten by junk; dense: None) and the slots' adapter ids
        (multi-LoRA only)."""
        tables = None
        if self.page_size:
            tables = torch.as_tensor(
                np.where(active[:, None], self._tables, 0),
                device=self.device)
        ids = None
        if self.cfg.multi_lora:
            ids = torch.as_tensor(self._adapter_ids, device=self.device)
        return tables, ids

    def _decode_chunk(self, active, tables, n, adapter_ids=None):
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
                                 self._cache, adapter_ids=adapter_ids)
            token, lp = self._sample(logits[:, -1])
            toks[i] = token
            lps[i] = lp
            # inactive slots freeze (their junk write lands in the dump
            # page or a row past their position); active ones clamp at
            # the last cache row: a chunk rounds up to a power of two,
            # so a slot whose budget ends mid-chunk keeps stepping and
            # its overshoot is discarded
            pos = torch.where(active, torch.clamp(pos + 1, max=last), pos)
        self._token, self._pos = token, pos
        return toks.cpu().numpy(), lps.cpu().numpy()

    def _run(self, progress):
        while (self._queue or self._prefilling
               or any(s.active for s in self._slots)):
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
            tables, ids = self._step_args(active)
            toks, lps = self._decode_chunk(
                torch.as_tensor(active, device=self.device), tables, n,
                ids)
            self.stats["steps"] += n
            self.stats["total_slot_steps"] += n * self.n_slots
            self.stats["active_slot_steps"] += int(active.sum()) * n
            self._observe_chunk(int(active.sum()), n)
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


class SpeculativeBatchingEngine(ContinuousBatchingEngine):
    """Continuous batching with per-slot speculative decoding: a DRAFT
    (typically the int8 weights of the same model) proposes ``k`` tokens
    a slot, one target forward verifies every slot's, and each slot
    accepts its own longest agreeing prefix plus the target's next token
    — greedy outputs are exactly the plain engine's.

    ``temperature > 0`` switches the round to distribution-exact
    rejection sampling
    (:func:`~sparkdl_tpu_torch.models.speculative.spec_sample_tokens`),
    with ``top_k`` / ``top_p`` restricting both the draft's and the
    target's distributions: the output is distributed as restricted
    target-only sampling, and the draft moves only the acceptance rate.

    The TARGET cache may be paged (``page_size=``): verify writes ride
    the slot's block table, and page reservation adds the k-token
    scratch (:meth:`_worst_case_tokens`). The DRAFT always keeps a dense
    slot cache. Prefix caching works on both sides: the target through
    the base engine, the draft through its own dense prefix rows.

    ``draft_params``: a state dict of ``draft_model`` (default: the
    target's architecture). Refuses a multi-LoRA model and chunked
    prefill, as the JAX engine does.
    """

    def __init__(self, model, params, draft_params, *, n_slots=4,
                 eos_id=None, k=4, generator=None, draft_model=None,
                 temperature=0.0, page_size=0, n_pages=None, top_k=0,
                 top_p=1.0, device=None):
        if model.cfg.multi_lora:
            raise ValueError(
                "SpeculativeBatchingEngine is single-adapter only")
        # set before super(): _worst_case_tokens needs it
        self.k = int(k)
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        super().__init__(model, params, n_slots=n_slots,
                         temperature=temperature, eos_id=eos_id,
                         page_size=page_size, n_pages=n_pages, top_k=top_k,
                         top_p=top_p, device=device, generator=generator)
        d_base = draft_model.cfg if draft_model is not None else model.cfg
        self._draft_cfg = dataclasses.replace(
            d_base, decode=True, max_cache_len=self.cfg.max_cache_len,
            page_size=0, n_pages=0)
        self.draft_params = draft_params
        self._draft = Llama.from_params(self._draft_cfg, draft_params,
                                        self.device)
        self._draft_prefixes = {}  # prefix_id -> the draft's (k, v) rows
        self._d_cache = self._draft.init_cache(batch=self.n_slots)
        self.stats.update(rounds=0, proposed=0, accepted=0)

    def _worst_case_tokens(self, p_len, max_new):
        # + k scratch: a verify may write k positions past the final
        # accepted token; those rows (and, paged, their pages) must be
        # the request's own, never a neighbour's
        return p_len + max_new + self.k

    def submit(self, prompt_tokens, max_new_tokens, prefix_id=None,
               adapter_id=0, stop=None):
        prompt = np.asarray(prompt_tokens, np.int32).reshape(-1)
        if self._worst_case_tokens(len(prompt), max_new_tokens) \
                > self.cfg.max_cache_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) + k ({self.k}) speculation scratch "
                f"exceeds max_cache_len ({self.cfg.max_cache_len}); raise "
                "max_cache_len or lower k")
        return super().submit(prompt, max_new_tokens, prefix_id=prefix_id,
                              adapter_id=adapter_id, stop=stop)

    def register_prefix(self, prefix_tokens, adapter_id=0):
        """Shared-prefix caching for BOTH models: the target's through
        the base engine, the draft's as its own dense rows, so a
        prefixed admission prefills only the suffix on both sides and
        the draft stays position-correct."""
        pid = super().register_prefix(prefix_tokens, adapter_id)
        prefix = np.asarray(prefix_tokens, np.int32).reshape(-1)
        with torch.no_grad():
            self._draft_prefixes[pid] = _prefix_rows(self._draft, prefix)
        return pid

    def _draft_admit(self, slot_idx, prompt, prefix_id):
        """The prompt (or its suffix past a cached prefix) through the
        draft into its dense slot rows; the logits are discarded."""
        if slot_idx in self._prefilling:
            # a staged slot would speculate against the previous
            # occupant's draft rows
            raise RuntimeError(
                "speculative engine does not support chunked prefill")
        if not self._slots[slot_idx].active:
            return  # finished at admission: nothing to speculate
        start = 0
        if prefix_id is not None:
            start = len(self._prefixes[prefix_id][0])
            _copy_rows(self._d_cache, slot_idx,
                       self._draft_prefixes[prefix_id])
        _slot_prefill(self._draft, self._d_cache, slot_idx, prompt[start:],
                      start)

    def _admit(self, slot_idx):
        _, prompt, _, prefix_id, _ = self._queue[0]
        super()._admit(slot_idx)
        self._draft_admit(slot_idx, prompt, prefix_id)

    def _try_admit_paged(self, slot_idx):
        _, prompt, _, prefix_id, _ = self._queue[0]
        if not super()._try_admit_paged(slot_idx):
            return False
        self._draft_admit(slot_idx, prompt, prefix_id)
        return True

    def _restricted_probs(self, logits):
        # restricting BOTH p and q to the top-k / nucleus support keeps
        # the scheme exact for the restricted target distribution
        return torch.softmax(
            restrict_logits(logits.float() / self.temperature,
                            top_k=self.top_k, top_p=self.top_p), dim=-1)

    def _round(self, active, tables):
        """One speculation round over every slot: the draft takes k
        slot-mapped steps, ONE target forward scores the k+1 positions,
        and acceptance runs on the device; returns (tokens (B, k+1),
        counts (B,), logprobs (B, k+1)) as host arrays, the round's one
        host copy. Rejected rows above a slot's accepted position are
        junk that the next round's writes cover before any query can see
        them (its write window [pos', pos' + k] spans them, as pos
        advances by at most k + 1)."""
        from sparkdl_tpu_torch.models.speculative import (
            assemble_round,
            spec_sample_tokens,
        )

        L, k = self.cfg.max_cache_len, self.k
        token, pos = self._token, self._pos
        tok, p = token, pos
        props, q_rows = [], []
        for _ in range(k):
            last = self._draft(tok[:, None], p[:, None],
                               cache=self._d_cache)[:, -1]
            if self.temperature == 0.0:
                tok = torch.argmax(last, -1).to(torch.int32)
            else:
                q_row = self._restricted_probs(last)
                tok = torch.multinomial(q_row, 1, generator=self._generator
                                        )[:, 0].to(torch.int32)
                q_rows.append(q_row)
            props.append(tok)
            p = torch.where(active, torch.clamp(p + 1, max=L - 1), p)
        # a logits-discarded step writes the last proposal's K/V: a fully
        # accepted round advances past it
        self._draft(tok[:, None], p[:, None], cache=self._d_cache)
        prop = torch.stack(props, 1)                            # (B, k)
        offs = torch.arange(k + 1, device=self.device)
        ppos = torch.clamp(pos[:, None] + offs[None], max=L - 1)
        ppos = torch.where(active[:, None], ppos, pos[:, None])
        seq = torch.cat([token[:, None], prop], 1)
        logits = self._model(seq, ppos, tables, self._cache)
        if self.temperature == 0.0:
            greedy = torch.argmax(logits, -1).to(torch.int32)   # (B, k+1)
            agree = prop == greedy[:, :k]
            all_acc = agree.all(-1)
            m = torch.where(all_acc, k,
                            torch.argmin(agree.to(torch.int32), -1))
            final = torch.gather(greedy, 1, m[:, None])[:, 0]
            tokens, counts = assemble_round(prop, m, final)
            lp_all = torch.log_softmax(logits.float(), -1)
        else:
            p_probs = self._restricted_probs(logits)
            tokens, counts = spec_sample_tokens(
                torch.stack(q_rows, 1), p_probs, prop, self._generator)
            lp_all = torch.log(torch.clamp(p_probs, min=1e-30))
        # each token's logprob under the TARGET distribution at its
        # verified position (the plain engine's convention)
        lps = torch.gather(lp_all, -1, tokens[..., None].long())[..., 0]
        return (tokens.cpu().numpy(), counts.cpu().numpy(),
                lps.cpu().numpy())

    def _run(self, progress):
        while (self._queue or self._prefilling
               or any(s.active for s in self._slots)):
            active = self._fill_slots()
            if not active.any():
                self._deadend_check()
                continue
            tables, _ = self._step_args(active)
            tokens, counts, lps = self._round(
                torch.as_tensor(active, device=self.device), tables)
            n_act = int(active.sum())
            self.stats["rounds"] += 1
            self.stats["proposed"] += self.k * n_act
            self.stats["steps"] += 1
            self.stats["total_slot_steps"] += self.n_slots
            self.stats["active_slot_steps"] += n_act
            # one round: up to k + 1 tokens a slot
            self._observe_chunk(n_act, self.k + 1)
            new_pos = self._pos.cpu().numpy().copy()
            new_tok = self._token.cpu().numpy().copy()
            for i, s in enumerate(self._slots):
                if not s.active:
                    continue
                cnt = int(counts[i])
                # cnt - 1 proposals survived; the last token is the bonus
                # (full acceptance) or the correction (first rejection)
                self.stats["accepted"] += cnt - 1
                if not self._accept_tokens(i, tokens[i, :cnt],
                                           lps[i, :cnt]):
                    new_pos[i] += cnt
                    new_tok[i] = tokens[i, cnt - 1]
            self._pos = torch.as_tensor(new_pos, device=self.device)
            self._token = torch.as_tensor(new_tok, device=self.device)
            if progress is not None:
                progress(self)
        self.stats["acceptance_rate"] = (
            self.stats["accepted"] / max(1, self.stats["proposed"]))
        return self._drain_results()
