"""The port's own multi-rank program: the counterpart of the repo's
``__graft_entry__.py`` (the JAX package's, which the port does not
import).

- :func:`entry` — the flagship forward: Llama with LoRA at
  ``__graft_entry__``'s config, ``(fn, (params, tokens))`` with
  ``fn(params, tokens)`` the logits (``torch.func.functional_call`` over
  the state dict).
- :func:`build_multichip_step` — ONE LoRA training step, for one rank of
  an n-rank ``data x seq x model`` mesh carved as the JAX program's
  (``model`` and ``seq`` get 2 each when they fit, ``data`` the rest),
  with every parallel form of the port in one loss:

  - dp: the global batch's rows over ``data`` (``shard_batch``);
  - tp: Megatron's column and row splits by ``TRANSFORMER_RULES``;
  - sp: ring attention over ``seq`` (``make_ring_attention``);
  - pp: a GPipe term whose stages ride ``model`` (``make_pipeline``);
  - ep: an expert-parallel MoE term whose experts ride ``seq``
    (``expert_parallel_moe``, its psum combine over every ``seq``
    rank's tokens, gathered);

  the three terms chained (the logits feed the pipeline, whose output
  feeds the MoE), so every collective lies on one path of the forward
  and the backward, and AdamW through ``make_train_step``. Every
  collective goes through the port's ``Mesh``, so
  :func:`~sparkdl_tpu_torch.analysis.trace.trace_step` records it.
- :func:`dryrun_multichip` — one real step as an n-rank gang through
  ``HorovodRunner``, asserting a finite loss.

``python -m sparkdl_tpu_torch.analysis --graft N`` traces
:func:`build_multichip_step` as every rank of its mesh on ``meta``
tensors, in one process. The Llama is JAX's tiny graft config but for
its heads: 2 of 64 dims where JAX has 4 of 16, the head dims the flash
kernels take (the card's step runs them); 2 kv heads split over
``model`` = 2; :data:`SEQ_PER_RANK` tokens a ``seq`` rank.
"""

import math

import numpy as np
import torch

# the pipeline's and the expert layer's width (JAX's d_pipe)
D_PIPE = 16
# microbatches of the pipeline term, and the MoE term's leading dim
N_MICRO, N_MOE_ROWS = 4, 2
# tokens a seq rank, as JAX has
SEQ_PER_RANK = 8
# the chained loss's weights: cross entropy, the pipeline term, the MoE
# term (JAX's)
TERM_WEIGHTS = (1.0, 1e-3, 1e-3)
# the mesh axes that split the batch, over which the step averages
_DATA_AXES = ("data", "fsdp", "seq")


def _flagship_cfg():
    from sparkdl_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=32000, d_model=512, n_layers=4, n_heads=8,
                       n_kv_heads=4, d_ff=1536, dtype=torch.bfloat16,
                       lora_rank=8)


def entry(device=None):
    """``(fn, (params, tokens))``: the flagship forward (Llama with LoRA,
    ``__graft_entry__.py``'s config) and its example arguments, 4 x 256
    tokens from seed 0. On ``"meta"`` the weights are shapes only (the
    JAX test's ``eval_shape``); elsewhere they are drawn from seed 0."""
    from sparkdl_tpu_torch.models.llama import Llama, init_weights
    from sparkdl_tpu_torch.ops._dispatch import resolve_device

    device = resolve_device(device)
    cfg = _flagship_cfg()
    model = Llama(cfg, device=device)
    if device.type != "meta":
        init_weights(model, torch.Generator(device=device).manual_seed(0))
    tokens = torch.as_tensor(
        np.random.RandomState(0).randint(0, cfg.vocab_size, (4, 256)),
        dtype=torch.int32, device=device)
    params = dict(model.state_dict())

    def fn(params, tokens):
        return torch.func.functional_call(model, params, (tokens,))

    return fn, (params, tokens)


def mesh_spec(n_devices):
    """The JAX program's carving of ``n_devices``: ``model`` and ``seq``
    get 2 each when they fit, ``data`` the rest."""
    from sparkdl_tpu_torch.parallel.mesh import MeshSpec

    model_p = 2 if n_devices % 2 == 0 else 1
    seq_p = 2 if n_devices % (model_p * 2) == 0 else 1
    return MeshSpec(data=n_devices // (model_p * seq_p), seq=seq_p,
                    model=model_p)


class GraftModel(torch.nn.Module):
    """The step's parameters: the Llama (``llama``), this rank's pipeline
    stage (``pipe_w``, (1, D_PIPE, D_PIPE) of the stacked stages) and
    this rank's experts with the whole router (``moe``). ``mesh`` is the
    whole mesh (the step averages over its data-like axes);
    ``shardings`` the leaves' layouts (name -> spec), from which
    ``grad_split_axes`` takes the data-like axes that split a leaf (the
    experts' ``seq``)."""

    def __init__(self, llama, pipe_w, moe, mesh, shardings):
        from sparkdl_tpu_torch.parallel.sharding import _names

        super().__init__()
        self.llama = llama
        self.pipe_w = torch.nn.Parameter(pipe_w)
        self.moe = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(v) for k, v in moe.items()})
        self.mesh = mesh
        self.zero3 = None
        self.grad_split_axes = {}
        for name, p in self.named_parameters():
            axes = tuple(a for dim in shardings.get(name, ()) or ()
                         for a in _names(dim) if a in _DATA_AXES)
            if axes:
                self.grad_split_axes[id(p)] = axes


def whole_weights(cfg, n_stages):
    """The program's whole weights from seed 0, as every rank draws them
    before it keeps its slice: the Llama's state dict, the stacked
    (n_stages, D_PIPE, D_PIPE) stage weights and the MoE's router and 4
    stacked experts."""
    from sparkdl_tpu_torch.models.llama import Llama, init_weights

    gen = torch.Generator().manual_seed(0)
    full = init_weights(Llama(cfg, device="cpu"), gen).state_dict()
    stacked = torch.randn((n_stages, D_PIPE, D_PIPE), generator=gen) * 0.3
    moe = {
        "router_kernel": torch.randn((D_PIPE, 4), generator=gen) * 0.05,
        "router_bias": torch.zeros(4),
        "w_gate": torch.randn((4, D_PIPE, 32), generator=gen) * 0.05,
        "w_up": torch.randn((4, D_PIPE, 32), generator=gen) * 0.05,
        "w_down": torch.randn((4, 32, D_PIPE), generator=gen) * 0.05,
    }
    return full, stacked, moe


def graft_config(dtype=torch.float32):
    """The program's Llama: JAX's tiny graft config but for its heads
    (module docstring)."""
    from sparkdl_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.tiny(d_model=128, n_layers=2, n_heads=2,
                            n_kv_heads=2, d_ff=256, vocab_size=256,
                            dtype=dtype, lora_rank=4)


def build_multichip_step(n_devices, *, mesh=None, device=None, dtype=None,
                         attention=None, term_weights=TERM_WEIGHTS):
    """Build (not run) the dp+tp+sp+pp+ep LoRA training step (module
    docstring) for one rank of an ``n_devices`` mesh. Returns ``(step,
    params, opt_state, batch, mesh, shardings)`` as the JAX function
    does: ``step(batch)`` takes the GLOBAL batch (numpy) and cuts this
    rank's block of it itself; ``params`` is the :class:`GraftModel`;
    ``opt_state`` the AdamW optimizer (empty until the first step);
    ``shardings`` the Llama's ``tp_specs``, the stage weight's and the
    experts' (leaf name -> spec).

    :param mesh: the gang's :class:`~sparkdl_tpu_torch.parallel.mesh.Mesh`
        (``make_mesh(mesh_spec(n))`` in a worker); None: one built
        without a process group, whose rank a trace sets.
    :param device: where the weights live (CUDA unless named; the CLI
        builds on ``"cpu"`` and traces on ``meta``).
    :param dtype: the Llama's (bf16 on CUDA, for the flash kernels; fp32
        elsewhere, as the JAX config).
    :param attention: the ring's blocks, ``"flash"`` or ``"dense"``
        (flash on CUDA, dense elsewhere).
    :param term_weights: the weights of the loss's three terms (cross
        entropy, pipeline, MoE).
    """
    from sparkdl_tpu_torch.models.llama import Llama
    from sparkdl_tpu_torch.models.lora import lora_mask
    from sparkdl_tpu_torch.models.moe import MoEConfig, expert_parallel_moe
    from sparkdl_tpu_torch.ops._dispatch import resolve_device
    from sparkdl_tpu_torch.parallel.mesh import AXES, Mesh, sharded_param
    from sparkdl_tpu_torch.parallel.pipeline import make_pipeline
    from sparkdl_tpu_torch.parallel.ring_attention import make_ring_attention
    from sparkdl_tpu_torch.parallel.train import (
        cross_entropy_loss,
        make_train_step,
        shard_batch,
    )

    device = resolve_device(device)
    card = device.type == "cuda"
    spec = mesh_spec(n_devices)
    if mesh is None:
        mesh = Mesh(AXES, spec.axis_sizes())
    elif dict(mesh.shape) != dict(zip(AXES, spec.axis_sizes())):
        raise ValueError(f"the mesh {dict(mesh.shape)} is not the carving "
                         f"of {n_devices} ranks: {spec}")
    cfg = graft_config(dtype or (torch.bfloat16 if card else torch.float32))
    # the whole weights from seed 0 on every rank; each keeps its slice
    n_stages = mesh.axis_size("model")
    full, stacked, whole = whole_weights(cfg, n_stages)
    ring = make_ring_attention(
        mesh, impl=attention or ("flash" if card else "dense"))
    llama = Llama.from_params(cfg, full, mesh=mesh, device=device,
                              attention_fn=ring)

    # pp: one stage a coordinate of `model`, this rank's (1, D_PIPE,
    # D_PIPE) block of the stacked (stages, D_PIPE, D_PIPE) weight
    stage = mesh.axis_index("model")
    pipe_w = stacked[stage:stage + 1]
    pipe = make_pipeline(mesh, lambda w, x: torch.tanh(x @ w[0]),
                         axis_name="model")

    # ep: the experts' stacked weights split over `seq`, the router whole
    moe_cfg = MoEConfig(d_model=D_PIPE, d_ff=32, n_experts=4, top_k=2)
    e_local = moe_cfg.n_experts // mesh.axis_size("seq")
    lo = mesh.axis_index("seq") * e_local
    moe = {k: (v[lo:lo + e_local] if k.startswith("w_") else v).to(device)
           for k, v in whole.items()}
    shardings = {f"llama.{k}": v for k, v in (llama.tp_specs or {}).items()}
    shardings["pipe_w"] = ("model", None, None)
    shardings.update({f"moe.{k}": ("seq",) for k in ("w_gate", "w_up",
                                                      "w_down")})
    model = GraftModel(llama, pipe_w.to(device), moe, mesh, shardings)
    ep = expert_parallel_moe(mesh, moe_cfg, axis_name="seq")
    w_ce, w_pipe, w_moe = term_weights

    def loss_fn(batch):
        logits = model.llama(batch["inputs"], batch.get("positions"))
        loss = w_ce * cross_entropy_loss(logits, batch["targets"])
        feats = logits[..., :D_PIPE].reshape(N_MICRO, -1, D_PIPE)
        pipe_out = pipe(model.pipe_w, feats)
        loss = loss + w_pipe * (pipe_out ** 2).mean()
        # the psum combine wants every seq rank's tokens on every seq
        # rank, and each seq rank's loss holds the MoE term of them all:
        # the gather's backward sums the ranks' cotangents (a
        # reduce-scatter), so each rank's tokens get the gradient of
        # every rank's term, as the step's mean over the ranks needs
        x = sharded_param(pipe_out.reshape(N_MOE_ROWS, -1, D_PIPE), mesh,
                          "seq", dim=0)
        m = model.moe
        moe_out = ep({"router": {"kernel": m["router_kernel"],
                                 "bias": m["router_bias"]},
                      "w_gate": m["w_gate"], "w_up": m["w_up"],
                      "w_down": m["w_down"]}, x)
        return loss + w_moe * (moe_out ** 2).mean()

    loss_fn.model = model
    # LoRA on the Llama; the stage and the experts train fully
    mask = {f"llama.{k}": v for k, v in lora_mask(llama).items()}
    mask.update({n: True for n, _ in model.named_parameters()
                 if not n.startswith("llama.")})
    named = dict(model.named_parameters())
    opt = torch.optim.AdamW([named[n] for n in named if mask[n]], lr=1e-3)
    base_step = make_train_step(loss_fn, opt, param_mask=mask, device=device)

    def step(batch):
        return base_step(shard_batch(batch, mesh, seq_axis=True))

    step.model, step.optimizer = model, opt
    rng = np.random.default_rng(0)
    rows, seq = 2 * spec.data, SEQ_PER_RANK * spec.seq
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (rows, seq)
                                    ).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (rows, seq)
                                     ).astype(np.int32)}
    return step, model, opt, batch, mesh, shardings


def _dryrun_main(n_devices, device):
    """Every rank of :func:`dryrun_multichip`: one step, a finite loss,
    the local parameter shapes kept."""
    from sparkdl_tpu_torch import hvd
    from sparkdl_tpu_torch.hvd import _state
    from sparkdl_tpu_torch.parallel.mesh import make_mesh

    torch.manual_seed(0)
    hvd.init()
    mesh = make_mesh(mesh_spec(n_devices))
    device = device or _state.state().device
    step, model, _, batch, _, _ = build_multichip_step(
        n_devices, mesh=mesh, device=device)
    before = {n: tuple(p.shape) for n, p in model.named_parameters()}
    loss = float(step(batch)["loss"])
    after = {n: tuple(p.shape) for n, p in model.named_parameters()}
    if not math.isfinite(loss):
        raise AssertionError(f"rank {hvd.rank()}: dryrun loss not finite: "
                             f"{loss}")
    return hvd.allgather_object({"rank": hvd.rank(), "loss": loss,
                                 "shapes_kept": before == after,
                                 "device": str(next(model.parameters())
                                               .device)})


def dryrun_multichip(n_devices, device=None):
    """Run :func:`build_multichip_step`'s step once as an ``n_devices``
    gang through ``HorovodRunner``: ``np=n`` (one rank a card, or a core
    under ``launcher.WORKER_DEVICE = "cpu"``), or, for one rank, local
    mode (``np=-1``, in this process). Asserts every rank's loss finite
    and its parameters' local shapes kept (the step is a sharding fixed
    point); returns the ranks' records. ``device``: the ranks' (default:
    the card a rank binds, the card in local mode)."""
    from sparkdl_tpu_torch import HorovodRunner

    ranks = HorovodRunner(np=-1 if n_devices == 1 else n_devices).run(
        _dryrun_main, n_devices=n_devices, device=device)
    bad = [r for r in ranks
           if not (math.isfinite(r["loss"]) and r["shapes_kept"])]
    if len(ranks) != n_devices or bad:
        raise AssertionError(f"dryrun_multichip({n_devices}): {ranks}")
    return ranks
