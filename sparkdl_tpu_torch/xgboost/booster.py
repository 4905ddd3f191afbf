"""Gradient-boosted decision trees on the card: the engine behind
:mod:`sparkdl_tpu_torch.xgboost`.

Counterpart of ``sparkdl_tpu/xgboost/booster.py``, with its algorithm,
its names and its files; PyTorch inside:

- **hist method**: features are quantile-binned to ``max_bins`` once
  (:func:`compute_bin_edges` in numpy, so the edges are the JAX
  package's exactly; the bins on the device, with ``torch.searchsorted``,
  which gives numpy's). Missing values get a bin of their own, from
  which each split learns a default direction.
- **Level-wise growth in dense arrays**: a complete binary tree of depth
  ``max_depth``; each level's per-(node, feature, bin) gradient and
  hessian sums are one ``scatter_add_`` each over a flat index (the JAX
  package's two ``segment_sum``), then the split (cumulative sums, the
  gain of both missing directions, monotone clamps, an argmax, ``gamma``
  as the threshold) and the route.
- **Device-resident**: the binned matrix (feature-major, ``(F, n)``),
  the gradients and the margins live on the device for the whole fit.
  A single-process tree is built with no host sync (:func:`_build_tree`);
  only the finished tree's arrays come back to numpy.
- **Distributed = per-level histogram all-reduce**: with ``hist_reduce``
  (``f(np.ndarray) -> np.ndarray``; ``hvd.allreduce(op=Sum)`` in a gang)
  the stages run one level at a time and the stacked
  ``(2, nodes, F, bins + 1)`` histogram crosses the host between the
  histogram and the split, so every rank splits on the same sums and
  builds the same tree.

``device`` is an argument (:func:`train`, :meth:`Booster.predict_margin`):
None is the rank's bound device in a gang (``hvd`` initialized), else
the card; without one it raises. ``device="cpu"`` runs the same code on
the CPU. Objectives: ``reg:squarederror``, ``binary:logistic``,
``multi:softprob``.
"""

import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

logger = logging.getLogger("sparkdl.xgboost")


def _device(device):
    """The fit's or the prediction's device: ``device`` when given, else
    the rank's bound device inside a gang, else the card."""
    from sparkdl_tpu_torch.ops._dispatch import resolve_device

    if device is None:
        from sparkdl_tpu_torch.hvd import _state

        st = _state.state()
        if st.initialized and st.device is not None:
            return st.device
    return resolve_device(device)


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------


def _column_edges(col, max_bins, missing):
    if np.isnan(missing):
        valid = col[~np.isnan(col)]
    else:
        valid = col[(col != missing) & ~np.isnan(col)]
    if valid.size == 0:
        return None
    return np.quantile(valid.astype(np.float64),
                       np.linspace(0, 1, max_bins + 1)[1:-1])


def compute_bin_edges(X, max_bins, missing=np.nan):
    """Per-feature quantile bin edges, ignoring missing values (the JAX
    package's numpy, a feature a thread: numpy's partition releases the
    GIL, and each column's edges are the same)."""
    n, f = X.shape
    edges = np.zeros((f, max_bins - 1), np.float32)
    workers = min(f, os.cpu_count() or 1) if n * f >= 1 << 20 else 1
    with ThreadPoolExecutor(workers) as pool:
        cols = pool.map(lambda j: _column_edges(X[:, j], max_bins, missing),
                        range(f))
        for j, qs in enumerate(cols):
            if qs is not None:
                edges[j] = qs.astype(np.float32)
    return edges


def bin_data(X, edges, missing=np.nan):
    """Map raw features to bin indices in numpy; missing -> bin
    ``max_bins`` (its own bin, so each split can learn a default
    direction). The host reference of :func:`bin_on`."""
    n, f = X.shape
    max_bins = edges.shape[1] + 1
    out = np.empty((n, f), np.int32)
    for j in range(f):
        out[:, j] = np.searchsorted(edges[j], X[:, j], side="right")
    if np.isnan(missing):
        miss = np.isnan(X)
    else:
        miss = (X == missing) | np.isnan(X)
    out[miss] = max_bins
    return out


def bin_on(X, edges, missing, device):
    """:func:`bin_data` on ``device``, feature-major: an ``(F, n)`` int16
    tensor (int32 past 32766 bins). ``torch.searchsorted(right=True)``
    compares float32 as numpy's ``side="right"`` does."""
    max_bins = edges.shape[1] + 1
    X = np.asarray(X, np.float32)
    if not X.flags.writeable:  # a memory map (external storage)
        X = np.array(X)
    xt = torch.as_tensor(X).to(device).T.contiguous()
    e = torch.as_tensor(np.asarray(edges, np.float32), device=device)
    out = torch.searchsorted(e, xt, right=True, out_int32=True)
    miss = torch.isnan(xt)
    if not np.isnan(missing):
        miss |= xt == float(missing)
    out.masked_fill_(miss, max_bins)
    return out.to(torch.int16 if max_bins < 32767 else torch.int32)


# ---------------------------------------------------------------------------
# Tree-building stages (plain functions on device tensors)
# ---------------------------------------------------------------------------


def _hist_stage(binned, g, h, pos, level_start, *, nodes_d, n_bins_tot):
    """Per-(node, feature, bin) gradient/hessian histograms of one level,
    ``(nodes, F, bins + 1)`` each, from the feature-major ``binned``.
    Rows already settled in an earlier leaf contribute zero."""
    f, n = binned.shape
    node_local = pos - level_start
    active = (node_local >= 0) & (node_local < nodes_d)
    node_local = node_local.clamp(0, nodes_d - 1)
    gz = torch.where(active, g, 0.0)
    hz = torch.where(active, h, 0.0)
    index = binned.to(torch.int64) + (node_local * n_bins_tot)[None, :]
    size = nodes_d * n_bins_tot
    hg = g.new_zeros((f, size)).scatter_add_(1, index, gz[None].expand(f, n))
    hh = h.new_zeros((f, size)).scatter_add_(1, index, hz[None].expand(f, n))
    hg = hg.view(f, nodes_d, n_bins_tot).permute(1, 0, 2)
    hh = hh.view(f, nodes_d, n_bins_tot).permute(1, 0, 2)
    return hg, hh


def _split_stage(hist_g, hist_h, feature_mask, lower=None, upper=None,
                 *, reg_lambda, reg_alpha, gamma, min_child_weight,
                 learning_rate, monotone=None):
    """Best (feature, threshold, missing direction) per node and the
    node's would-be leaf weight, every candidate at once, with no
    data-dependent control flow (the JAX stage's math, term for term).

    Monotone constraints: ``monotone`` is a per-feature vector in
    {-1, 0, +1}; ``lower``/``upper`` are the node's inherited bounds in
    RAW weight space (no learning-rate factor). Candidate child weights
    are clamped to them, their gains recomputed from the clamped weights
    (xgboost's CalcGainGivenWeight), and splits whose clamped child
    weights violate the feature's direction are rejected."""
    nodes_d, f, n_bins_tot = hist_g.shape
    n_bins = n_bins_tot - 1  # the last slot is the missing bin
    neg_inf = float("-inf")

    def soft(gs):
        return torch.sign(gs) * torch.clamp_min(gs.abs() - reg_alpha, 0.0)

    def score(gs, hs):
        return soft(gs) ** 2 / (hs + reg_lambda)

    miss_g = hist_g[..., n_bins]          # (nodes, F)
    miss_h = hist_h[..., n_bins]
    cg = torch.cumsum(hist_g[..., :n_bins], dim=-1)  # (nodes, F, B)
    ch = torch.cumsum(hist_h[..., :n_bins], dim=-1)
    g_tot = cg[..., -1] + miss_g          # (nodes, F), the same for all F
    h_tot = ch[..., -1] + miss_h
    # thresholds t = 0..B-2: left = bins <= t
    gl = cg[..., :-1]                     # (nodes, F, B-1)
    hl = ch[..., :-1]
    parent = score(g_tot[..., :1, None], h_tot[..., :1, None])
    if monotone is not None:
        c = torch.as_tensor(monotone, dtype=torch.int32,
                            device=hist_g.device)[None, :, None]

    def raw_weight(gs, hs):
        # the optimal leaf value in RAW space (lr scales at the end)
        return -soft(gs) / (hs + reg_lambda)

    def clamp(ws):
        if lower is None:
            return ws
        idx = (...,) + (None,) * (ws.ndim - 1)
        return torch.minimum(torch.maximum(ws, lower[idx]), upper[idx])

    def score_given_weight(gs, hs, ws):
        # the objective reduction a leaf value ws achieves
        return -(2.0 * gs * ws + (hs + reg_lambda) * ws * ws
                 + 2.0 * reg_alpha * ws.abs())

    def split_gain(gl_, hl_):
        # RAW loss improvement (xgboost's loss_chg); gamma is only the
        # acceptance threshold below
        gr_ = g_tot[..., None] - gl_
        hr_ = h_tot[..., None] - hl_
        if monotone is None:
            gain = 0.5 * (score(gl_, hl_) + score(gr_, hr_) - parent)
        else:
            wl_ = clamp(raw_weight(gl_, hl_))
            wr_ = clamp(raw_weight(gr_, hr_))
            parent_w = clamp(raw_weight(g_tot[..., :1, None],
                                        h_tot[..., :1, None]))
            gain = 0.5 * (
                score_given_weight(gl_, hl_, wl_)
                + score_given_weight(gr_, hr_, wr_)
                - score_given_weight(g_tot[..., :1, None],
                                     h_tot[..., :1, None], parent_w))
        ok = (hl_ >= min_child_weight) & (hr_ >= min_child_weight)
        if monotone is not None:
            ok = ok & ~((c > 0) & (wl_ > wr_)) & ~((c < 0) & (wl_ < wr_))
        return torch.where(ok, gain, neg_inf)

    gain_mr = split_gain(gl, hl)                              # missing->right
    gl_ml = gl + miss_g[..., None]
    hl_ml = hl + miss_h[..., None]
    gain_ml = split_gain(gl_ml, hl_ml)
    gain = torch.maximum(gain_mr, gain_ml)                    # (nodes,F,B-1)
    missing_left = gain_ml >= gain_mr
    gain = torch.where(feature_mask[None, :, None], gain, neg_inf)

    flat = gain.reshape(nodes_d, -1)
    best = torch.argmax(flat, dim=1)  # the first maximum, as jnp.argmax

    def pick(arr3):
        return torch.take_along_dim(arr3.reshape(nodes_d, -1),
                                    best[:, None], dim=1)[:, 0]

    best_gain = pick(gain)
    best_feat = best // (n_bins - 1)
    best_thr = best % (n_bins - 1)
    best_ml = pick(missing_left)
    # the node's leaf weight if it does NOT split (and at the last level)
    raw_leaf = raw_weight(g_tot[:, 0], h_tot[:, 0])
    if lower is not None:
        raw_leaf = torch.minimum(torch.maximum(raw_leaf, lower), upper)
    leaf_w = learning_rate * raw_leaf
    empty = h_tot[:, 0] <= 0.0
    leaf_w = torch.where(empty, 0.0, leaf_w)
    do_split = best_gain > gamma

    # the chosen split's clamped RAW child weights, for the caller's bound
    # propagation; zeros when constraints are off
    if monotone is not None:
        gl_best = torch.where(best_ml, pick(gl_ml), pick(gl))
        hl_best = torch.where(best_ml, pick(hl_ml), pick(hl))
        wl_best = raw_weight(gl_best, hl_best)
        wr_best = raw_weight(g_tot[:, 0] - gl_best, h_tot[:, 0] - hl_best)
        if lower is not None:
            wl_best = torch.minimum(torch.maximum(wl_best, lower), upper)
            wr_best = torch.minimum(torch.maximum(wr_best, lower), upper)
    else:
        wl_best = torch.zeros_like(leaf_w)
        wr_best = torch.zeros_like(leaf_w)
    return (do_split, best_feat, best_thr, best_ml, leaf_w, best_gain,
            wl_best, wr_best)


def _row_bins(binned, feat_of_row):
    """Each row's bin of its own feature: ``binned[feat_of_row[r], r]``."""
    return binned.gather(0, feat_of_row[None, :])[0]


def _route_stage(binned, pos, level_start, do_split, feat, thr,
                 missing_left, *, nodes_d, n_bins):
    """Advance each active row to its child node."""
    node_local = pos - level_start
    active = (node_local >= 0) & (node_local < nodes_d)
    nl = node_local.clamp(0, nodes_d - 1)
    row_feat = _row_bins(binned, feat[nl])
    is_missing = row_feat == n_bins
    go_right = torch.where(is_missing, ~missing_left[nl], row_feat > thr[nl])
    child = 2 * pos + 1 + go_right.to(pos.dtype)
    return torch.where(active & do_split[nl], child, pos)


def _predict_stage(binned, feat, thr, missing_left, is_split, leaf_w,
                   *, max_depth, n_bins):
    """Vectorized descent of one tree for every row."""
    n = binned.shape[1]
    pos = torch.zeros((n,), dtype=torch.int64, device=binned.device)
    for _ in range(max_depth):
        row_feat = _row_bins(binned, feat[pos])
        is_missing = row_feat == n_bins
        go_right = torch.where(is_missing, ~missing_left[pos],
                               row_feat > thr[pos])
        child = 2 * pos + 1 + go_right.to(pos.dtype)
        pos = torch.where(is_split[pos], child, pos)
    return leaf_w[pos]


def _monotone_child_bounds(lower, upper, wl, wr, constraint, do_split):
    """Child [lower, upper] RAW-weight bounds for the next level (a +1
    split caps the left subtree at mid and floors the right, mirrored for
    -1; unconstrained features pass bounds through)."""
    mid = 0.5 * (wl + wr)
    pos = do_split & (constraint > 0)
    neg = do_split & (constraint < 0)
    l_lo = torch.where(neg, torch.maximum(lower, mid), lower)
    l_hi = torch.where(pos, torch.minimum(upper, mid), upper)
    r_lo = torch.where(pos, torch.maximum(lower, mid), lower)
    r_hi = torch.where(neg, torch.minimum(upper, mid), upper)

    def interleave(a, b):
        return torch.stack([a, b], dim=1).reshape(-1)

    return interleave(l_lo, r_lo), interleave(l_hi, r_hi)


def _new_tree_arrays(n_nodes, device):
    return {
        "feat": torch.zeros((n_nodes,), dtype=torch.int64, device=device),
        "thr": torch.zeros((n_nodes,), dtype=torch.int64, device=device),
        "missing_left": torch.zeros((n_nodes,), dtype=torch.bool,
                                    device=device),
        "is_split": torch.zeros((n_nodes,), dtype=torch.bool, device=device),
        "leaf_w": torch.zeros((n_nodes,), dtype=torch.float32, device=device),
        "gain": torch.zeros((n_nodes,), dtype=torch.float32, device=device),
    }


def _set_level(tree, sl, do_split, bf, bt, bml, leaf_w, gains):
    tree["feat"][sl] = bf
    tree["gain"][sl] = torch.where(do_split, torch.clamp_min(gains, 0.0),
                                   0.0)
    tree["thr"][sl] = bt
    tree["missing_left"][sl] = bml
    tree["is_split"][sl] = do_split
    tree["leaf_w"][sl] = torch.where(do_split, 0.0, leaf_w)


def _build_tree(binned, g, h, feature_mask, hist_reduce=None, *,
                max_depth, n_bins_tot, reg_lambda, reg_alpha, gamma,
                min_child_weight, learning_rate, monotone=None):
    """One tree's device arrays and its margin deltas.

    Without ``hist_reduce``: every level (histogram -> split -> route)
    on the device with no host sync, the JAX package's
    ``_build_tree_fused``. With it: the JAX package's staged loop
    (``train``'s distributed path), where each level's stacked
    ``(2, nodes, F, bins + 1)`` histogram goes through ``hist_reduce`` on
    the host between the histogram and the split (the bounds need no
    reduction: they derive from the reduced sums, the same everywhere),
    and the tree stops at the first level that splits no node (one host
    sync a level)."""
    n_bins = n_bins_tot - 1
    device = binned.device
    tree = _new_tree_arrays(2 ** (max_depth + 1) - 1, device)
    pos = torch.zeros((binned.shape[1],), dtype=torch.int64, device=device)
    lower = torch.full((1,), float("-inf"), device=device)
    upper = torch.full((1,), float("inf"), device=device)
    if monotone is not None:
        mono = torch.as_tensor(monotone, dtype=torch.int32, device=device)
    for d in range(max_depth + 1):
        nodes_d = 2 ** d
        level_start = nodes_d - 1
        hg, hh = _hist_stage(binned, g, h, pos, level_start,
                             nodes_d=nodes_d, n_bins_tot=n_bins_tot)
        if hist_reduce is not None:
            # THE distributed step: one all-reduce a level (Rabit's)
            stacked = hist_reduce(torch.stack([hg, hh]).cpu().numpy())
            hg, hh = torch.as_tensor(np.asarray(stacked),
                                     dtype=torch.float32, device=device)
        do_split, bf, bt, bml, leaf_w, gains, wl, wr = _split_stage(
            hg, hh, feature_mask,
            lower if monotone is not None else None,
            upper if monotone is not None else None,
            reg_lambda=reg_lambda, reg_alpha=reg_alpha, gamma=gamma,
            min_child_weight=min_child_weight,
            learning_rate=learning_rate, monotone=monotone)
        if d == max_depth:
            do_split = torch.zeros_like(do_split)
        _set_level(tree, slice(level_start, level_start + nodes_d),
                   do_split, bf, bt, bml, leaf_w, gains)
        if hist_reduce is not None and not bool(do_split.any()):
            break
        if d < max_depth:
            pos = _route_stage(binned, pos, level_start, do_split, bf, bt,
                               bml, nodes_d=nodes_d, n_bins=n_bins)
            if monotone is not None:
                lower, upper = _monotone_child_bounds(
                    lower, upper, wl, wr, mono[bf], do_split)
    delta = _predict_stage(binned, tree["feat"], tree["thr"],
                           tree["missing_left"], tree["is_split"],
                           tree["leaf_w"], max_depth=max_depth, n_bins=n_bins)
    return tree, delta


def _tree_to_numpy(tree):
    """The finished tree's arrays on the host, in the JAX package's
    dtypes (the ``trees.npz`` format)."""
    out = {k: v.cpu().numpy() for k, v in tree.items()}
    out["feat"] = out["feat"].astype(np.int32)
    out["thr"] = out["thr"].astype(np.int32)
    return out


def _tree_to_device(tree, device):
    return {k: torch.as_tensor(
        v, dtype=torch.int64 if k in ("feat", "thr") else None,
        device=device) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Objectives / metrics
# ---------------------------------------------------------------------------


def _grad_hess(objective, margins, y, weights, n_classes):
    if objective == "reg:squarederror":
        g = margins[:, 0] - y
        h = torch.ones_like(g)
        g, h = g[:, None], h[:, None]
    elif objective == "binary:logistic":
        p = 1.0 / (1.0 + torch.exp(-margins[:, 0]))
        g, h = (p - y)[:, None], (p * (1.0 - p))[:, None]
    elif objective == "multi:softprob":
        m = margins - margins.max(dim=1, keepdim=True).values
        e = torch.exp(m)
        p = e / e.sum(dim=1, keepdim=True)
        classes = torch.arange(n_classes, device=margins.device)
        onehot = (y[:, None] == classes[None, :]).to(p.dtype)
        g, h = p - onehot, p * (1.0 - p)
    else:
        raise ValueError(f"Unsupported objective: {objective}")
    return g * weights[:, None], h * weights[:, None]


def _eval_metric(metric, margins, y, n_classes):
    m = np.asarray(margins)
    if metric == "rmse":
        return float(np.sqrt(np.mean((m[:, 0] - y) ** 2)))
    if metric == "logloss":
        p = 1.0 / (1.0 + np.exp(-m[:, 0]))
        p = np.clip(p, 1e-15, 1 - 1e-15)
        return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))
    if metric == "mlogloss":
        mm = m - m.max(axis=1, keepdims=True)
        p = np.exp(mm) / np.exp(mm).sum(axis=1, keepdims=True)
        p = np.clip(p[np.arange(len(y)), y.astype(int)], 1e-15, None)
        return float(-np.mean(np.log(p)))
    if metric == "error":
        if m.shape[1] == 1:
            pred = (m[:, 0] > 0).astype(int)
        else:
            pred = m.argmax(axis=1)
        return float(np.mean(pred != y))
    raise ValueError(f"Unsupported eval_metric: {metric}")


_DEFAULT_METRIC = {
    "reg:squarederror": "rmse",
    "binary:logistic": "logloss",
    "multi:softprob": "mlogloss",
}


# ---------------------------------------------------------------------------
# Booster
# ---------------------------------------------------------------------------


class Booster:
    """A trained forest: dense per-tree numpy arrays and the binning
    metadata (``xgboost.core.Booster``'s role: what ``model.get_booster()``
    returns and what ``xgb_model`` warm start consumes). Its files are the
    JAX package's ``booster.json`` and ``trees.npz``: either package loads
    the other's model."""

    def __init__(self, params, edges, missing, trees, base_score,
                 n_classes, best_iteration=None, n_base_trees=0):
        self.params = dict(params)
        self.edges = edges
        self.missing = missing
        self.trees = trees  # list of dicts of np arrays, len = rounds*K
        self.base_score = base_score
        self.n_classes = n_classes
        # best_iteration counts boosting rounds of the LAST train() call;
        # n_base_trees is how many trees predate it (warm start), which
        # best-iteration truncation must keep
        self.best_iteration = best_iteration
        self.n_base_trees = n_base_trees

    # -- persistence --------------------------------------------------------

    def save(self, path):
        os.makedirs(path, exist_ok=True)
        base = self.base_score
        if isinstance(base, np.ndarray):
            base = base.tolist()
        elif isinstance(base, (np.floating, np.integer)):
            base = float(base)
        meta = {
            "params": self.params,
            "missing": None if np.isnan(self.missing) else float(self.missing),
            "base_score": base,
            "n_classes": self.n_classes,
            "n_trees": len(self.trees),
            "best_iteration": self.best_iteration,
            "n_base_trees": self.n_base_trees,
        }

        def _np_safe(o):
            if isinstance(o, (np.floating, np.integer)):
                return o.item()
            if isinstance(o, np.ndarray):
                return o.tolist()
            raise TypeError(f"not JSON serializable: {type(o)}")

        with open(os.path.join(path, "booster.json"), "w") as fh:
            json.dump(meta, fh, default=_np_safe)
        arrays = {"edges": self.edges}
        for i, t in enumerate(self.trees):
            for k, v in t.items():
                arrays[f"t{i}_{k}"] = v
        np.savez_compressed(os.path.join(path, "trees.npz"), **arrays)

    @classmethod
    def load(cls, path):
        with open(os.path.join(path, "booster.json")) as fh:
            meta = json.load(fh)
        data = np.load(os.path.join(path, "trees.npz"))
        trees = []
        keys = ("feat", "thr", "missing_left", "is_split", "leaf_w")
        for i in range(meta["n_trees"]):
            t = {k: data[f"t{i}_{k}"] for k in keys}
            gk = f"t{i}_gain"
            t["gain"] = (data[gk] if gk in data
                         else np.zeros_like(t["leaf_w"]))
            trees.append(t)
        missing = np.nan if meta["missing"] is None else meta["missing"]
        base = meta["base_score"]
        if isinstance(base, list):
            base = np.asarray(base, np.float32)
        return cls(meta["params"], data["edges"], missing, trees, base,
                   meta["n_classes"], meta.get("best_iteration"),
                   meta.get("n_base_trees", 0))

    # -- inference ----------------------------------------------------------

    def predict_margin(self, X, iteration_range=None, device=None):
        """Margins ``(n, k)`` as numpy float32; the rows are binned and
        every tree descended on ``device`` (None: the card, or the rank's
        bound device in a gang)."""
        device = _device(device)
        X = np.asarray(X, np.float32)
        binned = bin_on(X, self.edges, self.missing, device)
        max_depth = int(self.params["max_depth"])
        n_bins = self.edges.shape[1] + 1
        k = max(self.n_classes, 1) if self.n_classes > 2 else 1
        base = torch.as_tensor(np.asarray(self.base_score, np.float32),
                               device=device)
        margins = torch.zeros((X.shape[0], k), dtype=torch.float32,
                              device=device) + base
        trees = self.trees
        if iteration_range is None and self.best_iteration is not None:
            # keep warm-start trees + the best rounds of the last fit
            trees = trees[: self.n_base_trees + (self.best_iteration + 1) * k]
        elif iteration_range is not None:
            trees = trees[iteration_range[0] * k: iteration_range[1] * k]
        for i, t in enumerate(trees):
            t = _tree_to_device(t, device)
            margins[:, i % k] += _predict_stage(
                binned, t["feat"], t["thr"], t["missing_left"],
                t["is_split"], t["leaf_w"], max_depth=max_depth,
                n_bins=n_bins)
        return margins.cpu().numpy()

    def predict(self, X, device=None):
        m = self.predict_margin(X, device=device)
        obj = self.params.get("objective")
        if obj == "binary:logistic":
            return (1.0 / (1.0 + np.exp(-m[:, 0])) > 0.5).astype(np.int32)
        if obj == "multi:softprob":
            return m.argmax(axis=1).astype(np.int32)
        return m[:, 0]

    def feature_importances(self, importance_type="gain"):
        """Per-feature importances over the forest (xgboost sklearn-API
        semantics): ``gain`` = AVERAGE raw split gain per feature,
        ``total_gain`` = summed gains, ``weight`` = split counts — all
        normalized to sum to 1."""
        if importance_type not in ("gain", "total_gain", "weight"):
            raise ValueError(
                "importance_type must be 'gain', 'total_gain' or "
                f"'weight', got {importance_type!r}")
        n_features = self.edges.shape[0]
        gain_sum = np.zeros((n_features,), np.float64)
        counts = np.zeros((n_features,), np.float64)
        for t in self.trees:
            feats = t["feat"][t["is_split"]]
            np.add.at(gain_sum, feats, t["gain"][t["is_split"]])
            np.add.at(counts, feats, 1.0)
        if importance_type == "weight":
            acc = counts
        elif importance_type == "total_gain":
            acc = gain_sum
        else:  # xgboost's 'gain': average gain per split
            acc = np.divide(gain_sum, counts, out=np.zeros_like(gain_sum),
                            where=counts > 0)
        total = acc.sum()
        return (acc / total if total > 0 else acc).astype(np.float32)

    def predict_proba(self, X, device=None):
        m = self.predict_margin(X, device=device)
        if self.params.get("objective") == "binary:logistic":
            p1 = 1.0 / (1.0 + np.exp(-m[:, 0]))
            return np.stack([1 - p1, p1], axis=1)
        mm = m - m.max(axis=1, keepdims=True)
        e = np.exp(mm)
        return e / e.sum(axis=1, keepdims=True)


def _parse_monotone(spec, n_features):
    """xgboost's monotone_constraints formats -> int32 (n_features,)
    vector or None: "(1,-1,0)" string or list/tuple (length must equal
    n_features, as in xgboost), or a partial {feature_index: c} dict
    (unlisted features unconstrained)."""
    if spec is None:
        return None
    if isinstance(spec, str):
        body = spec.strip().strip("()")
        spec = [int(s) for s in body.split(",") if s.strip()] if body \
            else []
    if isinstance(spec, dict):
        if not spec:
            return None
        if not all(isinstance(k, (int, np.integer)) for k in spec):
            raise ValueError(
                "monotone_constraints dicts must be keyed by feature "
                "index (column names are not tracked here)")
        if not all(0 <= int(k) < n_features for k in spec):
            raise ValueError(
                f"monotone_constraints feature indices must be in "
                f"[0, {n_features}); got {sorted(spec)}")
        out = np.zeros(n_features, np.int32)
        for idx, c in spec.items():
            out[int(idx)] = int(c)
        arr = out
    else:
        arr = np.asarray(spec, np.int32).reshape(-1)
        if arr.size == 0:
            return None
        if arr.size != n_features:
            raise ValueError(
                f"monotone_constraints has {arr.size} entries for "
                f"{n_features} features")
    if not np.isin(arr, (-1, 0, 1)).all():
        raise ValueError(
            f"monotone_constraints values must be -1, 0, or 1; got "
            f"{sorted(set(arr.tolist()))}")
    return arr if np.any(arr) else None


def train(params, X, y, *, sample_weight=None, base_margin=None,
          eval_set=None, early_stopping_rounds=None, hist_reduce=None,
          callbacks=None, verbose_eval=False, xgb_model=None, device=None):
    """Train a Booster on ``device`` (None: the rank's bound device in a
    gang, else the card).

    :param hist_reduce: optional ``f(np.ndarray) -> np.ndarray`` summing
        histograms across workers (``hvd.allreduce(op=Sum)`` in a
        HorovodRunner gang, Rabit's role). Bin edges are made consistent
        across workers by averaging their quantiles through the same
        reducer, and so is the regression base score.
    """
    device = _device(device)
    p = dict(params)
    objective = p.setdefault("objective", "reg:squarederror")
    n_estimators = int(p.pop("n_estimators", 100))
    max_depth = int(p.setdefault("max_depth", 6))
    learning_rate = float(p.pop("learning_rate", 0.3))
    reg_lambda = float(p.pop("reg_lambda", 1.0))
    reg_alpha = float(p.pop("reg_alpha", 0.0))
    gamma = float(p.pop("gamma", 0.0))
    min_child_weight = float(p.pop("min_child_weight", 1.0))
    subsample = float(p.pop("subsample", 1.0))
    colsample_bytree = float(p.pop("colsample_bytree", 1.0))
    max_bins = int(p.pop("max_bin", p.pop("max_bins", 256)))
    missing = p.pop("missing", np.nan)
    scale_pos_weight = float(p.pop("scale_pos_weight", 1.0))
    user_base_score = p.pop("base_score", None)
    seed = int(p.pop("random_state", p.pop("seed", 0)))
    monotone_spec = p.pop("monotone_constraints", None)
    n_classes = int(p.pop("num_class", 0))
    eval_metric = p.pop("eval_metric", None) or _DEFAULT_METRIC[objective]
    p["max_depth"] = max_depth

    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.float32)
    n, f = X.shape
    monotone = _parse_monotone(monotone_spec, f)
    w = (np.ones(n, np.float32) if sample_weight is None
         else np.asarray(sample_weight, np.float32))
    if scale_pos_weight != 1.0:
        if objective == "binary:logistic":
            # xgboost semantics: positive-class instances weighted up
            w = np.where(y == 1.0, w * scale_pos_weight, w)
        else:
            logger.warning(
                "scale_pos_weight only applies to binary:logistic; "
                "ignored for objective %r.", objective)

    if xgb_model is not None:
        edges = xgb_model.edges
    else:
        edges = compute_bin_edges(X, max_bins, missing)
        if hist_reduce is not None:
            # deterministic global edges: average the workers' quantiles
            # (all workers must agree or their trees diverge)
            edges = hist_reduce(edges) / _reduce_count(hist_reduce)
    binned = bin_on(X, edges, missing, device)
    n_bins_tot = max_bins + 1

    k = n_classes if objective == "multi:softprob" else 1
    if k > 1 and n_classes < 2:
        raise ValueError("multi:softprob requires num_class >= 2")

    # base score (a warm start keeps the base its trees were fit against)
    if xgb_model is not None:
        base_score = xgb_model.base_score
        base = np.asarray(base_score, np.float32).reshape(-1)
    elif user_base_score is not None:
        # a probability for logistic objectives -> logit margin; raw
        # value otherwise (xgboost semantics)
        b = float(user_base_score)
        if objective == "binary:logistic":
            if not 0.0 < b < 1.0:
                raise ValueError(
                    f"base_score must be in (0, 1) for binary:logistic; "
                    f"got {b}")
            b = float(np.log(b / (1.0 - b)))
        base_score = np.float32(b)
        base = np.full((max(k, 1),), base_score, np.float32)
        if k > 1:
            base_score = base
    elif objective == "reg:squarederror":
        ssum = np.array([np.sum(y * w), np.sum(w)], np.float64)
        if hist_reduce is not None:
            ssum = hist_reduce(ssum)
        base_score = np.float32(ssum[0] / max(ssum[1], 1e-12))
        base = np.full((1,), base_score, np.float32)
    else:
        base = np.zeros((max(k, 1),), np.float32)
        base_score = base if k > 1 else np.float32(0.0)

    trees = list(xgb_model.trees) if xgb_model is not None else []
    margins_h = np.zeros((n, max(k, 1)), np.float32) + base
    if base_margin is not None:
        margins_h += np.asarray(base_margin, np.float32).reshape(n, -1)
    if xgb_model is not None and trees and base_margin is None:
        # continuation keeps ALL base trees, so the starting margins come
        # from the FULL base forest, not its best_iteration truncation
        full_range = (0, len(trees) // max(k, 1))
        margins_h = xgb_model.predict_margin(X, iteration_range=full_range,
                                             device=device)
    margins = torch.as_tensor(margins_h, dtype=torch.float32, device=device)
    y_t = torch.tensor(y, device=device)
    w_t = torch.tensor(w, device=device)

    n_base_trees = len(trees)

    # eval set (warm-start trees contribute to the metric too)
    ev = None
    if eval_set:
        Xv, yv = eval_set[0]
        Xv = np.asarray(Xv, np.float32)
        yv = np.asarray(yv, np.float32)
        binned_v = bin_on(Xv, edges, missing, device)
        if xgb_model is not None and n_base_trees:
            margins_v = xgb_model.predict_margin(
                Xv, iteration_range=(0, n_base_trees // max(k, 1)),
                device=device).astype(np.float32)
        else:
            margins_v = np.zeros((Xv.shape[0], max(k, 1)), np.float32) + base
        ev = (binned_v, yv, torch.as_tensor(margins_v, device=device))

    stage_kw = dict(max_depth=max_depth, n_bins_tot=n_bins_tot,
                    reg_lambda=reg_lambda, reg_alpha=reg_alpha, gamma=gamma,
                    min_child_weight=min_child_weight,
                    learning_rate=learning_rate, monotone=monotone)
    rng = np.random.RandomState(seed)
    best_score, best_iter, since_best = np.inf, 0, 0

    for rnd in range(n_estimators):
        g_all, h_all = _grad_hess(objective, margins, y_t, w_t, max(k, 1))
        # row and feature subsample (the same on every rank: every worker
        # draws the same seed sequence)
        row_mask = None
        if subsample < 1.0:
            row_mask = torch.as_tensor(
                (rng.rand(n) < subsample).astype(np.float32), device=device)
        feature_mask = np.ones((f,), bool)
        if colsample_bytree < 1.0:
            keep = max(1, int(round(colsample_bytree * f)))
            # a per-round RNG of its own: every worker picks the SAME
            # features whatever its row count
            frng = np.random.RandomState(seed * 100003 + rnd)
            feature_mask = np.zeros((f,), bool)
            feature_mask[frng.choice(f, keep, replace=False)] = True
        fmask = torch.as_tensor(feature_mask, device=device)

        for cls_i in range(max(k, 1)):
            g = g_all[:, cls_i]
            h = h_all[:, cls_i]
            if row_mask is not None:
                g, h = g * row_mask, h * row_mask
            tree, delta = _build_tree(binned, g, h, fmask, hist_reduce,
                                      **stage_kw)
            margins[:, cls_i] += delta
            if ev is not None:
                ev[2][:, cls_i] += _predict_stage(
                    ev[0], tree["feat"], tree["thr"], tree["missing_left"],
                    tree["is_split"], tree["leaf_w"], max_depth=max_depth,
                    n_bins=max_bins)
            trees.append(_tree_to_numpy(tree))

        if callbacks:
            m_host = margins.cpu().numpy()
            for cb in callbacks:
                try:
                    cb(rnd, m_host)
                except TypeError:
                    cb(rnd)
        if ev is not None:
            score = _eval_metric(eval_metric, ev[2].cpu().numpy(), ev[1],
                                 max(k, 1))
            if verbose_eval:
                print(f"[{rnd}] validation-{eval_metric}: {score:.6f}")
            if score < best_score - 1e-12:
                best_score, best_iter, since_best = score, rnd, 0
            else:
                since_best += 1
                if (early_stopping_rounds
                        and since_best >= early_stopping_rounds):
                    break

    return Booster(
        {**p, "objective": objective}, edges, missing, trees,
        base_score if k <= 1 else base, max(n_classes, k),
        best_iteration=(best_iter if ev is not None
                        and early_stopping_rounds else None),
        n_base_trees=n_base_trees)


def _reduce_count(hist_reduce):
    """Number of workers taking part in hist_reduce (a sum of ones)."""
    return float(hist_reduce(np.ones((1,), np.float64))[0])
