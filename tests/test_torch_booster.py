"""The port's GBDT booster against the JAX package's, on the CPU.

The same numpy inputs go through ``sparkdl_tpu.xgboost.booster`` (XLA on
the CPU) and ``sparkdl_tpu_torch.xgboost.booster`` (``device="cpu"``):
the bin edges and bins, each tree-building stage, whole forests of the
three objectives with their options, the fused path against the staged
one, early stopping, warm start, and the booster files, written by
either package and loaded by the other.

Tolerances (float32 throughout; the two packages sum the histograms in
the same row order on the CPU, but their ``exp`` and cumulative sums may
differ in the last bit):

- bin edges, bins, routes and tree structure (``is_split`` and, at split
  nodes, ``feat``, ``thr``, ``missing_left``): equal;
- histograms and leaf weights: ``rtol=1e-5, atol=1e-6``; gains within
  1e-5 of the tree's largest gain (a gain is a difference of scores);
- margins: ``atol=1e-5``; metrics and early-stopping rounds: equal.

A change of the rows' order changes the order of every float sum, as
the card's atomic adds do from run to run. Such a forest is held to
:data:`ORDER_TOL`: the same predicted class for 99.5 % of rows and the
train metric within 1e-3 relative (``chip_smoke.py`` phase 29a holds the
card's fit to the CPU's with the same numbers).
"""

import json
import os

import numpy as np
import pytest
import torch

from sparkdl_tpu.xgboost import booster as jb
from sparkdl_tpu_torch.xgboost import booster as pb

torch.set_num_threads(2)

CPU = torch.device("cpu")
STRUCT = ("feat", "thr", "missing_left")
ORDER_TOL = {"same_class": 0.995, "metric_rel": 1e-3}


def _data(n=300, f=5, seed=0, missing_frac=0.1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    if missing_frac:
        X[rng.random((n, f)) < missing_frac] = np.nan
    z = np.nan_to_num(X)
    y_bin = (z[:, 0] + 0.5 * z[:, 1] > 0).astype(np.float32)
    y_reg = (2 * z[:, 0] - z[:, 1] + 0.1 * rng.normal(size=n)).astype(
        np.float32)
    y_multi = np.digitize(z[:, 0], [-0.5, 0.5]).astype(np.float32)
    return X, {"binary:logistic": y_bin, "reg:squarederror": y_reg,
               "multi:softprob": y_multi}


def _structure(t):
    s = np.asarray(t["is_split"])
    return [s.tolist()] + [np.asarray(t[k])[s].tolist() for k in STRUCT]


def _first_difference(a, b):
    """The first node (breadth-first) whose split differs, or None."""
    for node in range(len(a["is_split"])):
        if a["is_split"][node] != b["is_split"][node] or (
                a["is_split"][node]
                and any(a[k][node] != b[k][node] for k in STRUCT)):
            return node
    return None


def assert_same_forest(jax_bst, port_bst, X, y=None, metric=None):
    """Equal structure and close numbers, tree by tree, up to a near-tie:
    a node where the two packages split differently is allowed only when
    both candidates' gains agree within 1e-5 of the tree's largest gain
    (the last bits of the sums chose). From that tree on the forests may
    differ, and they are held by ``metric`` on ``(X, y)`` (within 1e-3
    relative) instead of by their margins. Returns the near-tie's
    (tree, node), or None."""
    assert len(jax_bst.trees) == len(port_bst.trees)
    tie = None
    for i, (a, b) in enumerate(zip(jax_bst.trees, port_bst.trees)):
        node = _first_difference(a, b)
        if node is not None:
            scale = max(1.0, float(np.abs(a["gain"]).max()))
            assert abs(float(a["gain"][node]) - float(b["gain"][node])) \
                <= 1e-5 * scale, f"tree {i} node {node}: not a near-tie"
            tie = (i, node)
            break
        np.testing.assert_allclose(b["leaf_w"], a["leaf_w"], rtol=1e-5,
                                   atol=1e-6, err_msg=f"tree {i} leaf_w")
        # a gain is a difference of large scores: its error scales with
        # the tree's largest
        np.testing.assert_allclose(
            b["gain"], a["gain"], rtol=0,
            atol=1e-5 * max(1.0, float(np.abs(a["gain"]).max())),
            err_msg=f"tree {i} gain")
        assert {k: v.dtype for k, v in a.items()} == \
            {k: v.dtype for k, v in b.items()}
    mp = port_bst.predict_margin(X, device="cpu")
    mj = np.asarray(jax_bst.predict_margin(X))
    if tie is None:
        np.testing.assert_allclose(mp, mj, atol=1e-5)
    else:
        assert metric is not None, f"a near-tie at {tie} and no metric"
        k = mp.shape[1]
        want = jb._eval_metric(metric, mj, y, k)
        assert abs(pb._eval_metric(metric, mp, y, k) - want) \
            <= 1e-3 * abs(want), f"a near-tie at {tie}"
    assert port_bst.best_iteration == jax_bst.best_iteration
    assert port_bst.n_base_trees == jax_bst.n_base_trees
    np.testing.assert_array_equal(port_bst.edges, jax_bst.edges)
    np.testing.assert_array_equal(np.asarray(port_bst.base_score),
                                  np.asarray(jax_bst.base_score))
    return tie


# -- binning -------------------------------------------------------------------


@pytest.mark.parametrize("missing", [np.nan, 0.0])
def test_bin_edges_and_bins_are_the_jax_packages(missing):
    X, _ = _data(n=400)
    X[::7, 2] = 0.0
    X[:, 4] = np.round(X[:, 4])  # many equal quantiles
    edges = pb.compute_bin_edges(X, 32, missing)
    np.testing.assert_array_equal(edges, jb.compute_bin_edges(X, 32, missing))
    want = jb.bin_data(X, edges, missing)
    np.testing.assert_array_equal(pb.bin_data(X, edges, missing), want)
    got = pb.bin_on(X, edges, missing, CPU)
    assert got.dtype == torch.int16 and got.shape == (X.shape[1], len(X))
    np.testing.assert_array_equal(got.T.numpy(), want)


def test_threaded_edges_of_a_large_matrix_are_the_same():
    """Past 2^20 cells the edges are computed a feature a thread; each
    column's are numpy's, so the JAX package's exactly."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(70_000, 16)).astype(np.float32)
    X[rng.random(X.shape) < 0.01] = np.nan
    np.testing.assert_array_equal(pb.compute_bin_edges(X, 64),
                                  jb.compute_bin_edges(X, 64))


# -- the stages ------------------------------------------------------------------


@pytest.fixture(scope="module")
def level():
    """Level 2 of a depth-3 tree: binned rows, gradients and positions."""
    X, ys = _data(n=256)
    edges = jb.compute_bin_edges(X, 16)
    binned = jb.bin_data(X, edges)
    rng = np.random.default_rng(1)
    g = rng.normal(size=len(X)).astype(np.float32)
    h = rng.random(len(X)).astype(np.float32) + 0.1
    # rows spread over level 2 (nodes 3..6) and a few settled in node 1
    pos = rng.integers(3, 7, len(X)).astype(np.int32)
    pos[::9] = 1
    return binned, g, h, pos


def _t(a):
    return torch.as_tensor(np.array(a))


def test_hist_stage_matches(level):
    binned, g, h, pos = level
    want = jb._hist_stage(binned, g, h, pos, 3, nodes_d=4, n_bins_tot=17)
    got = pb._hist_stage(_t(binned.T.copy()), _t(g), _t(h), _t(pos).long(),
                         3, nodes_d=4, n_bins_tot=17)
    for w, o in zip(want, got):
        assert tuple(o.shape) == (4, 5, 17)
        np.testing.assert_allclose(o.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


SPLIT_KW = dict(reg_lambda=1.0, reg_alpha=0.1, gamma=0.05,
                min_child_weight=0.5, learning_rate=0.3)


def _split_pair(level, monotone=None, bounds=None, feature_mask=None,
                **kw):
    binned, g, h, pos = level
    hg, hh = jb._hist_stage(binned, g, h, pos, 3, nodes_d=4, n_bins_tot=17)
    hg, hh = np.asarray(hg), np.asarray(hh)
    fm = np.ones(5, bool) if feature_mask is None else feature_mask
    lo = hi = None
    if bounds is not None:
        lo, hi = (np.asarray(b, np.float32) for b in bounds)
    skw = dict(SPLIT_KW, **kw)
    want = jb._split_stage(hg, hh, fm, lo, hi, monotone=monotone, **skw)
    got = pb._split_stage(
        _t(hg), _t(hh), _t(fm), None if lo is None else _t(lo),
        None if hi is None else _t(hi), monotone=monotone, **skw)
    return [np.asarray(w) for w in want], [o.numpy() for o in got]


@pytest.mark.parametrize("case", ["plain", "monotone", "bounded",
                                  "feature_mask", "nan_gains"])
def test_split_stage_matches(level, case):
    kw = {}
    if case == "monotone":
        kw["monotone"] = np.array([1, -1, 0, 0, 1], np.int32)
    if case == "bounded":
        kw["monotone"] = np.array([1, -1, 0, 0, 1], np.int32)
        kw["bounds"] = ([-0.2, -np.inf, 0.0, -0.1], [0.1, 0.3, np.inf, 0.5])
    if case == "feature_mask":
        kw["feature_mask"] = np.array([False, True, False, True, True])
    if case == "nan_gains":
        # reg_lambda 0 and no child-weight floor: a 0/0 gain on the
        # empty bins; NaN is the maximum in both argmaxes
        kw.update(reg_lambda=0.0, min_child_weight=0.0, reg_alpha=0.0)
    want, got = _split_pair(level, **kw)
    names = ("do_split", "feat", "thr", "missing_left", "leaf_w", "gain",
             "wl", "wr")
    for name, w, o in zip(names, want, got):
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(o, w, err_msg=name)
        else:
            np.testing.assert_allclose(o, w, rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    if case == "nan_gains":
        assert np.isnan(want[5]).any() and np.isnan(got[5]).any()


def test_route_predict_and_bounds_match(level):
    binned, g, h, pos = level
    rng = np.random.default_rng(5)
    nodes = 15
    feat = rng.integers(0, 5, nodes).astype(np.int32)
    thr = rng.integers(0, 15, nodes).astype(np.int32)
    ml = rng.random(nodes) < 0.5
    split = rng.random(nodes) < 0.7
    leaf = rng.normal(size=nodes).astype(np.float32)
    bt = _t(binned.T.copy())
    want = jb._route_stage(binned, pos, 3, split[3:7], feat[3:7], thr[3:7],
                           ml[3:7], nodes_d=4, n_bins=16)
    got = pb._route_stage(bt, _t(pos).long(), 3, _t(split[3:7]),
                          _t(feat[3:7]).long(), _t(thr[3:7]).long(),
                          _t(ml[3:7]), nodes_d=4, n_bins=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jb._predict_stage(binned, feat, thr, ml, split, leaf,
                             max_depth=3, n_bins=16)
    got = pb._predict_stage(bt, _t(feat).long(), _t(thr).long(), _t(ml),
                            _t(split), _t(leaf), max_depth=3, n_bins=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lo = np.array([-1.0, -np.inf], np.float32)
    hi = np.array([np.inf, 0.5], np.float32)
    wl = np.array([0.2, -0.3], np.float32)
    wr = np.array([0.4, 0.1], np.float32)
    c = np.array([1, -1], np.int32)
    ds = np.array([True, True])
    want = jb._monotone_child_bounds(lo, hi, wl, wr, c, ds)
    got = pb._monotone_child_bounds(_t(lo), _t(hi), _t(wl), _t(wr), _t(c),
                                    _t(ds))
    for w, o in zip(want, got):
        np.testing.assert_array_equal(o.numpy(), np.asarray(w))


@pytest.mark.parametrize("objective", ["reg:squarederror",
                                       "binary:logistic", "multi:softprob"])
def test_grad_hess_matches(objective):
    rng = np.random.default_rng(2)
    k = 3 if objective == "multi:softprob" else 1
    m = rng.normal(size=(64, k)).astype(np.float32)
    y = rng.integers(0, max(k, 2), 64).astype(np.float32)
    w = rng.random(64).astype(np.float32)
    want = jb._grad_hess(objective, m, y, w, k)
    got = pb._grad_hess(objective, _t(m), _t(y), _t(w), k)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)


# -- whole forests ------------------------------------------------------------


FORESTS = {
    "binary": ("binary:logistic", {}),
    "binary_weighted": ("binary:logistic",
                        {"scale_pos_weight": 3.0, "base_score": 0.3,
                         "reg_alpha": 0.2, "gamma": 0.1}),
    "regression_monotone": ("reg:squarederror",
                            {"monotone_constraints": (1, -1, 0, 0, 0)}),
    "regression_missing_zero": ("reg:squarederror",
                                {"missing": 0.0, "base_score": 1.5}),
    "multiclass_subsampled": ("multi:softprob",
                              {"num_class": 3, "subsample": 0.8,
                               "colsample_bytree": 0.6, "seed": 7}),
}


@pytest.mark.parametrize("name", sorted(FORESTS))
def test_forest_matches_the_jax_booster(name):
    objective, extra = FORESTS[name]
    X, ys = _data()
    params = dict(objective=objective, n_estimators=5, max_depth=3,
                  max_bin=32, learning_rate=0.3, **extra)
    want = jb.train(dict(params), X, ys[objective])
    got = pb.train(dict(params), X, ys[objective], device="cpu")
    y = ys[objective]
    tie = assert_same_forest(want, got, X, y, jb._DEFAULT_METRIC[objective])
    assert got.params == want.params
    if tie is not None:
        return  # the predictions are held by the metric
    if objective == "reg:squarederror":
        np.testing.assert_allclose(got.predict(X, device="cpu"),
                                   want.predict(X), atol=1e-5)
    else:
        np.testing.assert_array_equal(got.predict(X, device="cpu"),
                                      want.predict(X))
        np.testing.assert_allclose(got.predict_proba(X, device="cpu"),
                                   want.predict_proba(X), atol=1e-6)


def test_missing_direction_ties_go_left_as_in_jax():
    """With no missing value both directions gain the same: the tie goes
    left in both packages (``gain_ml >= gain_mr``)."""
    X, ys = _data(seed=13, missing_frac=0.0)
    params = dict(objective="binary:logistic", n_estimators=3, max_depth=3,
                  max_bin=32)
    want = jb.train(dict(params), X, ys["binary:logistic"])
    got = pb.train(dict(params), X, ys["binary:logistic"], device="cpu")
    assert_same_forest(want, got, X, ys["binary:logistic"], "logloss")
    for t in got.trees:
        assert t["missing_left"][t["is_split"]].all()


def test_early_stopping_and_eval_metric_match():
    X, ys = _data(n=400, seed=4)
    params = dict(objective="binary:logistic", n_estimators=40, max_depth=4,
                  max_bin=16, learning_rate=0.8, eval_metric="logloss")
    # noisy labels on rows of their own: the validation loss turns up
    Xv, yvs = _data(n=150, seed=12)
    flip = np.random.default_rng(12).random(150) < 0.2
    yv = np.where(flip, 1 - yvs["binary:logistic"], yvs["binary:logistic"])
    rounds = {"jax": [], "port": []}

    def cb(side):
        return lambda rnd, margins: rounds[side].append(
            (rnd, margins.shape, margins.dtype))

    want = jb.train(dict(params), X, ys["binary:logistic"],
                    eval_set=[(Xv, yv)], early_stopping_rounds=3,
                    callbacks=[cb("jax")])
    got = pb.train(dict(params), X, ys["binary:logistic"],
                   eval_set=[(Xv, yv)], early_stopping_rounds=3,
                   callbacks=[cb("port")], device="cpu")
    assert got.best_iteration == want.best_iteration is not None
    assert len(got.trees) == len(want.trees) < 40  # stopped early
    assert rounds["port"] == rounds["jax"]
    assert_same_forest(want, got, X, ys["binary:logistic"], "logloss")


def test_warm_start_and_iteration_range_match():
    X, ys = _data(seed=6)
    y = ys["reg:squarederror"]
    params = dict(objective="reg:squarederror", n_estimators=4,
                  max_depth=3, max_bin=32)
    base_j = jb.train(dict(params), X, y)
    base_p = pb.train(dict(params), X, y, device="cpu")
    cont_j = jb.train(dict(params), X, y, xgb_model=base_j)
    cont_p = pb.train(dict(params), X, y, xgb_model=base_p, device="cpu")
    assert cont_p.n_base_trees == 4 and len(cont_p.trees) == 8
    assert_same_forest(cont_j, cont_p, X)
    np.testing.assert_allclose(
        cont_p.predict_margin(X, iteration_range=(1, 3), device="cpu"),
        cont_j.predict_margin(X, iteration_range=(1, 3)), atol=1e-5)


def test_fused_and_staged_paths_build_the_same_forest():
    """The staged path (``hist_reduce``, the gang's) through an identity
    reducer builds the fused path's trees, monotone bounds included."""
    X, ys = _data(n=200, seed=8)
    params = dict(objective="reg:squarederror", n_estimators=5,
                  max_depth=4, max_bin=32,
                  monotone_constraints=(1, -1, 0, 0, 0))
    fused = pb.train(dict(params), X, ys["reg:squarederror"], device="cpu")
    staged = pb.train(dict(params), X, ys["reg:squarederror"],
                      hist_reduce=lambda a: a, device="cpu")
    jax_staged = jb.train(dict(params), X, ys["reg:squarederror"],
                          hist_reduce=lambda a: a)
    for a, b in zip(fused.trees, staged.trees):
        assert _structure(a) == _structure(b)
        np.testing.assert_array_equal(a["leaf_w"], b["leaf_w"])
    assert_same_forest(jax_staged, staged, X)


def test_row_order_changes_sums_not_the_model():
    """Permuted rows sum every histogram in another order, as the card's
    atomic adds do; the forest stays within ORDER_TOL."""
    X, ys = _data(n=600, seed=9, missing_frac=0.0)
    y = ys["binary:logistic"]
    params = dict(objective="binary:logistic", n_estimators=8, max_depth=4,
                  max_bin=64, learning_rate=0.3)
    a = pb.train(dict(params), X, y, device="cpu")
    perm = np.random.default_rng(0).permutation(len(X))
    b = pb.train(dict(params), X[perm], y[perm], device="cpu")
    ma, mb = (t.predict_margin(X, device="cpu")[:, 0] for t in (a, b))
    assert ((ma > 0) == (mb > 0)).mean() >= ORDER_TOL["same_class"]
    la, lb = (pb._eval_metric("logloss", m[:, None], y, 1) for m in (ma, mb))
    assert abs(la - lb) <= ORDER_TOL["metric_rel"] * la


def test_metrics_and_monotone_specs_match():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(50, 3)).astype(np.float32)
    y = rng.integers(0, 3, 50).astype(np.float32)
    for metric, mm, yy in (("rmse", m[:, :1], y), ("logloss", m[:, :1],
                                                   (y > 0).astype(float)),
                           ("mlogloss", m, y), ("error", m, y),
                           ("error", m[:, :1], (y > 0).astype(float))):
        assert pb._eval_metric(metric, mm, yy, 3) == \
            jb._eval_metric(metric, mm, yy, 3)
    for spec in ((1, -1, 0), "(1,-1,0)", {0: 1, 2: -1}, None, {}, ()):
        want = jb._parse_monotone(spec, 3)
        got = pb._parse_monotone(spec, 3)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
    for bad, match in (((2, 0, 0), "must be -1, 0, or 1"),
                       ((1, 0), "entries"), ({"f0": 1}, "feature index"),
                       ({5: 1}, "indices")):
        with pytest.raises(ValueError, match=match):
            pb._parse_monotone(bad, 3)
        with pytest.raises(ValueError, match=match):
            jb._parse_monotone(bad, 3)


def test_unsupported_objective_and_logistic_base_score_raise():
    X, ys = _data(n=40)
    tweedie = {"objective": "reg:tweedie", "n_estimators": 1,
               "eval_metric": "rmse"}
    with pytest.raises(ValueError, match="Unsupported objective"):
        jb.train(dict(tweedie), X, ys["reg:squarederror"])
    with pytest.raises(ValueError, match="base_score"):
        pb.train({"objective": "binary:logistic", "base_score": 1.0,
                  "n_estimators": 1}, X, ys["binary:logistic"], device="cpu")
    with pytest.raises(ValueError, match="Unsupported objective"):
        pb.train(dict(tweedie), X, ys["reg:squarederror"], device="cpu")


# -- files -----------------------------------------------------------------------


@pytest.mark.parametrize("objective", ["binary:logistic", "multi:softprob"])
def test_booster_files_cross_between_the_packages(tmp_path, objective):
    X, ys = _data(seed=11)
    params = dict(objective=objective, n_estimators=3, max_depth=3,
                  max_bin=16, eval_metric=None)
    if objective == "multi:softprob":
        params["num_class"] = 3
    j = jb.train(dict(params), X, ys[objective],
                 eval_set=[(X[:50], ys[objective][:50])],
                 early_stopping_rounds=2)
    p = pb.train(dict(params), X, ys[objective],
                 eval_set=[(X[:50], ys[objective][:50])],
                 early_stopping_rounds=2, device="cpu")
    j.save(str(tmp_path / "jax"))
    p.save(str(tmp_path / "port"))
    meta = [json.loads((tmp_path / side / "booster.json").read_text())
            for side in ("jax", "port")]
    assert meta[0] == meta[1]
    assert sorted(np.load(tmp_path / "jax" / "trees.npz").files) == \
        sorted(np.load(tmp_path / "port" / "trees.npz").files)
    # each package loads the other's file and predicts as its writer
    from_jax = pb.Booster.load(str(tmp_path / "jax"))
    from_port = jb.Booster.load(str(tmp_path / "port"))
    np.testing.assert_array_equal(from_jax.predict_margin(X, device="cpu"),
                                  np.asarray(j.predict_margin(X)))
    np.testing.assert_allclose(from_port.predict_margin(X),
                               p.predict_margin(X, device="cpu"), atol=1e-6)
    np.testing.assert_allclose(
        from_jax.feature_importances("gain"), j.feature_importances("gain"))
    assert from_jax.best_iteration == j.best_iteration
    assert os.path.exists(tmp_path / "port" / "trees.npz")


def test_train_and_predict_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, ys = _data(n=30)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.train({"n_estimators": 1}, X, ys["reg:squarederror"])
    bst = pb.train({"n_estimators": 1, "max_depth": 2}, X,
                   ys["reg:squarederror"], device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bst.predict_margin(X)
    assert bst.predict_margin(X, device="cpu").shape == (30, 1)
