"""Ring attention: exact attention over a sequence sharded on the ``seq``
mesh axis, and the dense single-device oracle.

Counterpart of ``sparkdl_tpu/parallel/ring_attention.py``. Each rank
holds one contiguous shard of the sequence, (B, S_local, H, D) of q, k
and v at positions ``idx * S_local + arange(S_local)`` (``idx`` its
``seq`` coordinate); the K/V blocks travel the ring by the mesh's
neighbour exchange (:meth:`~sparkdl_tpu_torch.parallel.mesh.Mesh.ppermute_start`),
and after n - 1 hops every query block has seen every key block. Two
forms:

- :func:`ring_self_attention`, the dense ring: each hop attends its
  block in plain PyTorch with its own softmax statistics and folds them
  into running flash accumulators (:func:`_merge_stats`); it is
  differentiable by autograd, the hops' gradients taking the reverse
  hops;
- :func:`ring_flash_attention`, ring-flash: each hop runs the flash
  forward kernel (B1) on the block it holds, with ``causal`` on the
  diagonal block and not on blocks from earlier ranks; blocks from
  later ranks are wholly masked and launch nothing. The normalized
  partials merge in fp32 in logsumexp form (:func:`_lse_merge`). Its
  backward is a second ring (one ``autograd.Function``): with the
  forward's final lse and delta = sum(do * o), the dq (B2) and dk/dv
  (B3) kernels restricted to one K/V block give exactly that block's
  share, so dq accumulates here while the fp32 dk/dv accumulators
  travel with their K/V blocks and one more hop takes them home: n - 1
  K/V hops and n accumulator hops a tensor.

Two hop schedules, in both rings of both forms: ``overlap=True`` (the
default) issues the next hop before the block already held is
attended, so the transfer can run under the compute; ``overlap=False``
attends, then hops. They hop the same blocks the same number of times
and merge in the same order, so their results are bit-identical.

Differences from the JAX package: the functions take this rank's shards
and the :class:`~sparkdl_tpu_torch.parallel.mesh.Mesh` (one process a
rank, no ``shard_map``); :func:`make_ring_attention`'s ``impl=None``
takes the flash kernels for CUDA tensors and the dense ring for CPU
ones; ``overlap=None`` is True and no environment variable is read; the
kernels take the models' (B, S, H, D) layout, so nothing is transposed.
``bq``, ``bk`` and ``interpret`` are TPU settings and raise
NotImplementedError when given. The dense ring hops n - 1 times, like
ring-flash (the JAX dense ring's n-th hop returns each block to its
rank and is never read).
"""

import torch

from sparkdl_tpu_torch.ops import flash_attention as _flash

NEG_INF = -1e30


def attention_reference(q, k, v, *, causal=True, scale=None):
    """Attention on (B, S, H, D) tensors, k and v with q's head count.

    Scores and the PV product take input-dtype operands with fp32
    accumulation (the operands are widened to fp32, where the products
    of bf16 values are exact, so the sum is the JAX package's
    ``preferred_element_type=float32`` one); the softmax is fp32; the
    output comes back in v's dtype."""
    scale = scale or q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = s.shape[-2:]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o.to(v.dtype)


def resolve_overlap(overlap):
    """The hop schedule: an explicit ``overlap`` wins, None is True (the
    JAX package's default, which it reads from ``SPARKDL_TPU_OVERLAP``;
    the port reads no environment variable)."""
    return True if overlap is None else bool(overlap)


def _rows(x):
    """A per-row (B, H, S) statistic laid against (B, S, H, D)."""
    return x.transpose(1, 2)[..., None]


def _block_attend(q, k, v, mask, scale):
    """One (q block x kv block) piece with its own softmax statistics:
    q (B, Sq, H, D), k and v (B, Sk, H, D), mask (Sq, Sk) bool or None.
    Returns (o, m, l): the unnormalized fp32 output, row max and row sum
    (B, H, Sq). Operands widened to fp32 (exact products), the
    probabilities rounded to v's dtype for the PV product."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    p = p.masked_fill(m[..., None] <= NEG_INF / 2, 0.0)
    l = p.sum(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o, m, l


def _merge_stats(acc_o, acc_m, acc_l, o, m, l):
    """Fold one block's (o, m, l) into the running flash accumulators:
    the one merge both dense schedules share."""
    new_m = torch.maximum(acc_m, m)
    a = torch.exp(acc_m - new_m)
    bfac = torch.exp(m - new_m)
    acc_o = acc_o * _rows(a) + o * _rows(bfac)
    acc_l = acc_l * a + l * bfac
    return acc_o, new_m, acc_l


def _ring(mesh, axis_name, blocks, overlap, visit):
    """Walk the ring: ``visit(blocks, src)`` on the blocks this rank holds
    at each of the axis' n hops (``src`` the coordinate they came from),
    the blocks passed on between visits; ``overlap`` issues each hop
    before the visit of the blocks already held. n - 1 hops in all."""
    n = mesh.axis_size(axis_name)
    src = mesh.axis_index(axis_name)
    for t in range(n):
        last = t == n - 1
        if overlap and not last:
            pending = mesh.ppermute_start(blocks, axis_name)
        visit(blocks, src)
        if not last:
            if not overlap:
                pending = mesh.ppermute_start(blocks, axis_name)
            blocks = pending.wait()
            src = (src - 1) % n


def ring_self_attention(q, k, v, *, mesh, axis_name="seq", causal=True,
                        scale=None, overlap=None):
    """Exact attention of this rank's sequence shard over the whole
    sequence, the K/V blocks rotating on ``mesh``'s ``axis_name``: q, k,
    v (B, S_local, H, D), every rank's shard of one length. Dense
    blocks (:func:`_block_attend`) merged in flash form; differentiable.
    ``overlap`` selects the hop schedule (module docstring)."""
    overlap = resolve_overlap(overlap)
    idx = mesh.axis_index(axis_name)
    b, s_local, h, d = q.shape
    scale = scale or d ** -0.5
    arange = torch.arange(s_local, device=q.device)
    q_pos = idx * s_local + arange
    acc = [(torch.zeros((b, s_local, h, d), dtype=torch.float32,
                        device=q.device),
            torch.full((b, h, s_local), NEG_INF, dtype=torch.float32,
                       device=q.device),
            torch.zeros((b, h, s_local), dtype=torch.float32,
                        device=q.device))]

    def visit(blocks, src):
        mask = None
        if causal:
            mask = q_pos[:, None] >= (src * s_local + arange)[None, :]
        acc[0] = _merge_stats(*acc[0], *_block_attend(q, *blocks, mask,
                                                      scale))

    _ring(mesh, axis_name, (k, v), overlap, visit)
    acc_o, _, acc_l = acc[0]
    return (acc_o / _rows(acc_l.clamp_min(1e-30))).to(q.dtype)


def _lse_merge(acc_o, acc_lse, o, lse):
    """Merge one normalized block partial (o fp32 (B, S, H, D), lse
    (B, H, S)) in logsumexp form: the merge both flash schedules share."""
    new_lse = torch.logaddexp(acc_lse, lse)
    acc_o = (acc_o * _rows(torch.exp(acc_lse - new_lse))
             + o * _rows(torch.exp(lse - new_lse)))
    return acc_o, new_lse


def _live(causal, src, idx):
    """The causal flag of the hop whose K/V came from ``src``, or None
    when every key there is later than every query here (nothing to
    launch)."""
    if not causal:
        return False
    if src > idx:
        return None
    return src == idx


def _ring_flash_fwd(q, k, v, mesh, axis_name, causal, scale, overlap):
    """The forward ring: B1 on every live hop, partials merged in fp32.
    Returns (o fp32, lse (B, H, S) fp32)."""
    idx = mesh.axis_index(axis_name)
    acc = [None]

    def visit(blocks, src):
        diag = _live(causal, src, idx)
        if diag is None:
            return
        o, lse = _flash.flash_fwd(q, *blocks, diag, scale)
        part = (o.float(), lse)
        acc[0] = part if acc[0] is None else _lse_merge(*acc[0], *part)

    _ring(mesh, axis_name, (k, v), overlap, visit)
    return acc[0]


def _ring_flash_bwd(q, k, v, out, lse, do, mesh, axis_name, causal, scale,
                    overlap):
    """The second ring: B2 and B3 on every live hop against the global
    lse and delta; dq accumulates here, the fp32 dk/dv accumulators
    travel with their K/V blocks and take one more hop home."""
    n = mesh.axis_size(axis_name)
    idx = mesh.axis_index(axis_name)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    do = do.to(q.dtype).contiguous()

    def block_bwd(k_blk, v_blk, src):
        diag = _live(causal, src, idx)
        if diag is None:
            return None
        dq = _flash.flash_bwd_dq(q, k_blk, v_blk, do, lse, delta, diag,
                                 scale)
        dk, dv = _flash.flash_bwd_dkv(q, k_blk, v_blk, do, lse, delta, diag,
                                      scale)
        return dq.float(), dk.float(), dv.float()

    # the diagonal hop (own K/V) is always live
    if overlap and n > 1:
        pending = mesh.ppermute_start((k, v), axis_name)
    dq_acc, dk_acc, dv_acc = block_bwd(k, v, idx)
    blocks = pending.wait() if overlap and n > 1 else (k, v)
    src = idx
    for t in range(1, n):
        src = (src - 1) % n
        if overlap:
            # this hop's K/V arrived under the last hop's kernels; the
            # next hop's go out with the accumulators of the blocks
            # attended last, all in flight while this hop's kernels run
            nxt = blocks if t < n - 1 else ()
            pending = mesh.ppermute_start((dk_acc, dv_acc) + nxt, axis_name)
            part = block_bwd(*blocks, src)
            arrived = pending.wait()
            (dk_in, dv_in), blocks = arrived[:2], arrived[2:]
        else:
            arrived = mesh.ppermute_start(blocks + (dk_acc, dv_acc),
                                          axis_name).wait()
            blocks, (dk_in, dv_in) = arrived[:2], arrived[2:]
            part = block_bwd(*blocks, src)
        if part is None:
            dk_acc, dv_acc = dk_in, dv_in
        else:
            dq_acc = dq_acc + part[0]
            dk_acc, dv_acc = dk_in + part[1], dv_in + part[2]
    if n > 1:
        # the accumulators of the blocks last attended here go home
        dk_acc, dv_acc = mesh.ppermute_start((dk_acc, dv_acc),
                                             axis_name).wait()
    return dq_acc.to(q.dtype), dk_acc.to(k.dtype), dv_acc.to(v.dtype)


class _RingFlash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis_name, causal, scale, overlap):
        o, lse = _ring_flash_fwd(q, k, v, mesh, axis_name, causal, scale,
                                 overlap)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (mesh, axis_name, causal, scale, overlap)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_flash_bwd(q, k, v, out, lse, do, *ctx.ring)
        return dq, dk, dv, None, None, None, None, None


def _refuse_tpu_settings(fn, **settings):
    for name, value in settings.items():
        if value is not None:
            raise NotImplementedError(
                f"{fn}: {name} is a TPU setting and is not ported")


def ring_flash_attention(q, k, v, *, mesh, axis_name="seq", causal=True,
                         scale=None, bq=None, bk=None, interpret=None,
                         overlap=None):
    """Ring attention whose blocks run the flash kernels, with a fused
    two-ring backward (module docstring); the contract of
    :func:`ring_self_attention`. CPU tensors take the kernels' plain
    versions, CUDA tensors (bf16) the kernels. ``bq``, ``bk`` and
    ``interpret`` (TPU tiles, Pallas interpret mode) raise
    NotImplementedError when given."""
    _refuse_tpu_settings("ring_flash_attention", bq=bq, bk=bk,
                         interpret=interpret)
    return _RingFlash.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                            mesh, axis_name, causal, scale,
                            resolve_overlap(overlap))


def make_ring_attention(mesh, *, causal=True, impl=None, interpret=None,
                        overlap=None):
    """Bind ring attention to ``mesh``'s ``seq`` axis: returns ``f(q, k,
    v)`` on this rank's shards (B, S_local, H, D), the
    ``Llama(attention_fn=...)`` of sequence-parallel training.

    ``impl``: ``"flash"`` (:func:`ring_flash_attention`), ``"dense"``
    (:func:`ring_self_attention`), or None: flash for CUDA tensors,
    dense for CPU ones (the JAX package's ``use_pallas()``), chosen at
    each call. ``overlap`` selects the hop schedule of both rings;
    ``interpret`` raises NotImplementedError when given."""
    _refuse_tpu_settings("make_ring_attention", interpret=interpret)
    if impl not in (None, "dense", "flash"):
        raise ValueError(f"impl must be 'dense' or 'flash', got {impl!r}")

    def attend(q, k, v):
        kind = impl or ("flash" if q.device.type == "cuda" else "dense")
        fn = ring_flash_attention if kind == "flash" else ring_self_attention
        return fn(q, k, v, mesh=mesh, axis_name="seq", causal=causal,
                  overlap=overlap)

    return attend
