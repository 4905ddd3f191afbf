"""The trace the graph lints read (``analysis/trace.py``), on the CPU:
each kernel wrapper's trace path against its plain version, the FLOPs
of a tiny LoRA step against the analytic count, the live bytes of a
two-layer MLP step against a hand count, and the state a trace must
leave as it found it. No JAX here: the trace has no JAX counterpart to
hold it against beyond the graph passes' own pairs
(``tests/test_torch_graph_lint.py``)."""

import json

import numpy as np
import pytest
import torch

from sparkdl_tpu_torch import hvd, observe
from sparkdl_tpu_torch.analysis import lint_lowered
from sparkdl_tpu_torch.analysis.trace import (
    TracedCollectiveError,
    trace_step,
)
from sparkdl_tpu_torch.models.llama import Llama, LlamaConfig, init_weights
from sparkdl_tpu_torch.models.lora import lora_mask
from sparkdl_tpu_torch.ops import flash_attention as fa
from sparkdl_tpu_torch.ops import paged_attention as pa
from sparkdl_tpu_torch.ops import quantized_matmul as qmm
from sparkdl_tpu_torch.parallel.mesh import AXES, Mesh
from sparkdl_tpu_torch.parallel.train import (
    global_batch,
    lower_train_step,
    make_lm_loss_fn,
    make_train_step,
)

torch.set_num_threads(2)

B, S, H, D = 2, 32, 4, 64


def _bf16(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).bfloat16()


def _flash_inputs():
    q, k, v, do = (_bf16(B, S, H, D, seed=i) for i in range(4))
    o, lse = fa.flash_attention_reference(q, k, v)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def _paged_inputs():
    n_pages, page, hkv = 9, 16, 2
    q = _bf16(B, H, D)
    k_pool, v_pool = _bf16(n_pages, page, hkv, D, seed=1), _bf16(
        n_pages, page, hkv, D, seed=2)
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    lens = torch.tensor([40, 64], dtype=torch.int32)
    return q, k_pool, v_pool, tables, lens


def _qmm_inputs():
    w_q, scales = qmm.quantize_int8(torch.randn(128, 96))
    return _bf16(8, 128), w_q, scales


def _q4_inputs():
    packed, scales = qmm.quantize_int4(torch.randn(128, 96), group=64)
    return _bf16(8, 128), packed, scales


# (wrapper, reference, inputs, kernel id, FLOPs of the call)
KERNELS = {
    "B1": (fa.flash_fwd, fa.flash_attention_reference, _flash_inputs()[:3],
           fa.flash_flops("fwd", B, S, H, D, True)),
    "B2": (fa.flash_bwd_dq, fa.flash_bwd_dq_reference, _flash_inputs(),
           fa.flash_flops("dq", B, S, H, D, True)),
    "B3": (fa.flash_bwd_dkv, fa.flash_bwd_dkv_reference, _flash_inputs(),
           fa.flash_flops("dkv", B, S, H, D, True)),
    # the most the tables hold: 2 rows x 4 pages x 16, QK and PV
    "B4": (pa.paged_attention_decode, pa.paged_attention_decode_reference,
           _paged_inputs(), 2 * 4 * 16 * H * D * 2 * 2),
    "B5": (qmm.quantized_matmul, qmm.quantized_matmul_reference,
           _qmm_inputs(), 2 * 8 * 128 * 96),
    "B6": (qmm.quantized_matmul_int4, qmm.quantized_matmul_int4_reference,
           _q4_inputs(), 2 * 8 * 128 * 96),
}


def _specs(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in outs]


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_trace_path_gives_the_plain_versions_shapes_and_one_event(kernel):
    wrapper, reference, inputs, flops = KERNELS[kernel]
    ref = reference(*inputs)
    launches = wrapper.launches
    trace = trace_step(lambda *xs: wrapper(*xs), *inputs)
    (event,) = trace.kernels
    assert (event.kernel, event.name) == (kernel, wrapper.__name__)
    assert [(tuple(sh), getattr(torch, dt)) for sh, dt in event.outputs] \
        == _specs(ref)
    assert event.flops == flops and trace.flops == flops
    assert event.nbytes == sum(t.numel() * t.element_size() for t in inputs) \
        + sum(t.numel() * t.element_size() for t in (
            ref if isinstance(ref, tuple) else (ref,)))
    assert wrapper.launches == launches      # nothing launched, no count
    # meta inputs outside a trace: the outputs, no event anywhere
    metas = [torch.empty_like(t, device="meta") for t in inputs]
    assert _specs(wrapper(*metas)) == _specs(ref)


def test_the_trace_path_takes_the_kernels_checks():
    q, k, v = (torch.empty(B, S, H, D, device="meta") for _ in range(3))
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_fwd(q, k, v)        # fp32: the CUDA kernel's refusal


# -- a tiny LoRA step ----------------------------------------------------


def _lora_setup(seq=64):
    cfg = LlamaConfig.tiny(d_model=256, n_heads=4, n_kv_heads=2, d_ff=512,
                           vocab_size=512, attention="flash", lora_rank=8,
                           lora_alpha=8.0, lora_targets=("q_proj", "v_proj"))
    model = init_weights(Llama(cfg, device="cpu"),
                         torch.Generator().manual_seed(0))
    mask = lora_mask(model)
    opt = torch.optim.AdamW([p for n, p in model.named_parameters()
                             if mask[n]], lr=1e-3, weight_decay=1e-4)
    step = make_train_step(make_lm_loss_fn(model), opt, param_mask=mask,
                           device="cpu")
    batch = global_batch(np.random.default_rng(0), cfg.vocab_size, 2, seq)
    return cfg, model, opt, step, batch


def _analytic_lora_flops(cfg, b, s):
    """The matmuls of one LoRA step by hand, and the three flash kernels'
    own counts: forward 2 T K N a projection; dX of every projection
    whose input needs a gradient (all but layer 0's q, k and v, whose
    input is the frozen embedding's); the adapters' x A and (x A) B,
    their dB, d(x A) and dA, and d(x A) A^T where dX is; the head's
    forward and dX (frozen)."""
    T = b * s
    d, ff, V, r = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.lora_rank
    hd = d // cfg.n_heads
    dkv = cfg.n_kv_heads * hd
    proj = {"q": (d, d), "k": (d, dkv), "v": (d, dkv), "o": (d, d),
            "gate": (d, ff), "up": (d, ff), "down": (ff, d)}
    total = 2 * 2 * T * d * V
    for layer in range(cfg.n_layers):
        for name, (K, N) in proj.items():
            dx = layer > 0 or name not in ("q", "k", "v")
            total += 2 * T * K * N * (2 if dx else 1)
            if name in ("q", "v"):
                total += 2 * T * r * (K + N) + 2 * T * r * (2 * N + K)
                total += 2 * T * r * K if dx else 0
        total += sum(fa.flash_flops(kind, b, s, cfg.n_heads, hd, True)
                     for kind in ("fwd", "dq", "dkv"))
    return total


def test_lora_step_flops_are_the_analytic_count():
    cfg, model, opt, step, batch = _lora_setup()
    trace = lower_train_step(step, batch, cost_name=None)
    assert trace.flops == _analytic_lora_flops(cfg, 2, 64)
    assert trace.kernel_counts() == {"B1": cfg.n_layers, "B2": cfg.n_layers,
                                     "B3": cfg.n_layers}
    # the stock step updates in place and lints clean
    assert lint_lowered(trace) == []


def test_a_trace_leaves_the_step_as_it_found_it():
    """The model's tensors, the optimizer's state and the next real step
    are those of a twin that was never traced."""
    _, model, opt, step, batch = _lora_setup(seq=32)
    _, twin, _, twin_step, _ = _lora_setup(seq=32)
    step(batch)
    twin_step(batch)
    before = {n: (id(t), t.clone()) for n, t in
              model.state_dict(keep_vars=True).items()}
    state = {id(p): {k: v.clone() for k, v in st.items()}
             for p, st in opt.state.items()}
    trace = lower_train_step(step, batch, cost_name=None)
    assert trace.complete and trace.inputs
    after = model.state_dict(keep_vars=True)
    assert all(id(after[n]) == i and torch.equal(after[n], t)
               for n, (i, t) in before.items())
    assert {id(p): st for p, st in opt.state.items()}.keys() == state.keys()
    for p, st in opt.state.items():
        assert all(torch.equal(v, state[id(p)][k]) for k, v in st.items())
    assert step(batch)["loss"].item() == twin_step(batch)["loss"].item()
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  twin.parameters()))


# -- live bytes --------------------------------------------------------------


def test_live_bytes_peak_is_the_hand_count():
    """A two-layer MLP step, fp32, ``loss = (relu(x @ w1) @ w2).sum()``
    and its backward, counted by hand in bytes. Inputs: w1 (16, 32)
    2048, w2 (32, 4) 512, x (8, 16) 512: 3072. Forward: x @ w1 1024
    (live 4096), its relu 1024 (5120: the peak so far), then x @ w1 is
    freed (relu saves its output, the matmul saves its inputs); relu @ w2
    128, the loss 4, then relu @ w2 is freed (sum saves no tensor): 4100.
    Backward: the seed gradient (4; ``torch.autograd.backward`` holds it
    until it returns), an expand of it (a view); dW2 = relu^T g 512, dH
    = g w2^T 1024 (5636); dW2 goes to w2.grad as it is; relu's backward
    1024: **6664**; then dH and relu's saved output are freed (4616)
    and dW1 = x^T g 2048 makes 6664 again; the step ends at 5636 and
    returns the loss (4 bytes, not an input)."""
    params = {"w1": torch.ones(16, 32, requires_grad=True),
              "w2": torch.ones(32, 4, requires_grad=True)}

    def step(p, x):
        loss = (torch.relu(x @ p["w1"]) @ p["w2"]).sum()
        loss.backward()
        return loss.detach()

    trace = trace_step(step, params, torch.ones(8, 16))
    assert trace.memory_stats() == {
        "argument_size_in_bytes": 3072, "output_size_in_bytes": 4,
        "temp_size_in_bytes": 6664 - 3072 - 4, "alias_size_in_bytes": 0}
    assert trace.static_budget_bytes() == trace.peak_bytes == 6664


# -- lower_train_step ----------------------------------------------------


def test_lower_train_step_registers_cost_and_budget(tmp_path, monkeypatch):
    from sparkdl_tpu_torch.observe import mem, perf

    monkeypatch.setattr(observe, "TELEMETRY_DIR", str(tmp_path))
    observe._reset_for_tests()
    try:
        _, _, _, step, batch = _lora_setup(seq=16)
        trace = lower_train_step(step, batch, cost_name="lora")
        entry = perf._step_costs["lora"]
        assert entry["flops"] == trace.flops > 0
        assert entry["bytes_accessed"] == trace.bytes_accessed > 0
        assert mem.static_budget_bytes() == trace.static_budget_bytes()
        path = mem.write_oom_report("step", "out of memory",
                                    run_dir=str(tmp_path))
        with open(path) as f:
            assert json.load(f)["static_budget_bytes"] == \
                trace.static_budget_bytes()
    finally:
        observe._reset_for_tests()
        mem._reset_for_tests()


def test_lower_train_step_refuses_donation_by_name():
    # donate_argnums is the fix engine's manual seam now: an identity step
    # makes no replacement of its input to write into it, so the donation
    # is refused, the argument named
    with pytest.raises(ValueError, match=r"donate argument\(s\) \(0,\)"):
        lower_train_step(lambda x: x, torch.ones(2), donate_argnums=(0,))


# -- what a trace swaps and puts back -----------------------------------------


def test_hvd_mesh_and_distributed_are_put_back_after_a_failing_step():
    from sparkdl_tpu_torch.hvd import _state

    mesh = Mesh(AXES, (4, 1, 1, 1))
    real = torch.distributed.all_reduce
    before = (mesh.rank, dict(mesh.coords), dict(mesh.groups))
    hvd_before = _state.state().snapshot()

    def step(x):
        assert (hvd.rank(), mesh.axis_index("data")) == (3, 3)
        mesh.all_reduce(x, "data")
        raise KeyError("the step's own fault")

    with pytest.raises(KeyError):
        trace_step(step, torch.ones(2), mesh=mesh, rank=3)
    assert (mesh.rank, mesh.coords, mesh.groups) == before
    assert torch.distributed.all_reduce is real
    assert _state.state().snapshot() == hvd_before


def test_collectives_are_recorded_with_their_groups_and_lines():
    mesh = Mesh(AXES, (2, 1, 1, 2))

    def step(x):
        y = mesh.all_reduce(x, "model")
        return mesh.all_gather(y, "data", dim=0)

    trace = trace_step(step, torch.ones(3, 4), mesh=mesh, rank=3)
    red, gat = trace.collectives
    assert (red.kind, red.axis, red.ranks, red.shape) == (
        "all-reduce", "model", (2, 3), (3, 4))
    # the wire's result ((4, 3) moved to gather along dim 0), and the
    # whole the step goes on with among its forms
    assert (gat.kind, gat.axis, gat.ranks, gat.shape) == (
        "all-gather", "data", (1, 3), (8, 3))
    assert ("f32", (6, 4)) in gat.forms
    assert all("test_torch_trace.py" in c.location for c in trace.collectives)
    assert trace.signature() == (("all-reduce", "model", "f32"),
                                 ("all-gather", "data", "f32"))


def test_a_tensor_that_needs_grad_from_outside_is_named():
    outside = torch.ones(4, requires_grad=True)

    def step(x):
        return (x * outside).sum()

    with pytest.raises(ValueError, match="requires grad"):
        trace_step(step, torch.ones(4))


def test_direct_distributed_calls_are_refused_on_any_group():
    def step(x):
        torch.distributed.broadcast(x, src=0)
        return x

    with pytest.raises(TracedCollectiveError, match="broadcast"):
        trace_step(step, torch.ones(2), mesh={"data": 2}, rank=1)
