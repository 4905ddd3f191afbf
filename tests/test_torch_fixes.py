"""The port's fix engine against the JAX package's, scenario by scenario.

Each scenario of ``tests/analysis/test_fixes.py`` runs twice: the JAX
program through ``sparkdl_tpu.analysis.fix_program`` and its PyTorch
counterpart through the port's, on the same numpy inputs made from a
seed. Both must fix the same rules with the same actions, degrade the
same attempts and write reports of the same key tree, and the fixed
steps must compute what the JAX fixed programs compute (fp32, within
1e-6). The JAX engine's int64 cases have a documented counterpart: the
port's pass never flags int64 (torch's index dtype), so an int64
argument is neither flagged nor narrowed. Beyond JAX's corpus: the
traced peak of a fixed functional step falls by the predicted bytes, a
donation that only copies back is refused by the budget-delta proof,
and each case the donation plan must refuse degrades."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from sparkdl_tpu import analysis as janalysis
from sparkdl_tpu.analysis import fixes as jfixes
from sparkdl_tpu.utils.jax_compat import lowered_stablehlo
from sparkdl_tpu_torch.analysis import FIXIT_SCHEMA, Severity, fix_program
from sparkdl_tpu_torch.analysis import fixes
from sparkdl_tpu_torch.analysis.fixes import FIX_ACTIONS, render_fixit_text

torch.set_num_threads(2)

PROOF_KEYS = ("finding_eliminated", "no_new_errors",
              "numeric_equivalence", "budget_delta")
N = 32


def by_rule(findings, rule_id):
    return [f for f in findings if f.rule_id == rule_id]


def key_tree(x):
    """The nested key structure of a report (a list's elements merged)."""
    if isinstance(x, dict):
        return {k: key_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        merged = {}
        for e in x:
            t = key_tree(e)
            if isinstance(t, dict):
                _merge(merged, t)
        return ("list", merged)
    return None


def _merge(into, tree):
    for k, v in tree.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            _merge(into[k], v)
        elif k not in into or into[k] is None:
            into[k] = v


def same_outcome(jres, tres):
    """Same rules fixed, actions, degrades and report key tree."""
    def outcome(res):
        return [(a.rule_id, a.action, a.verified, a.applied, a.degraded)
                for a in res.attempts]

    assert outcome(tres) == outcome(jres)
    assert key_tree(tres.report) == key_tree(jres.report)
    for ja, ta in zip(jres.attempts, tres.attempts):
        assert set(ta.proofs) == set(ja.proofs)
        if ja.fix is not None:
            assert key_tree(ta.fix.to_dict()) == key_tree(ja.fix.to_dict())


def close(torch_out, jax_out, atol=1e-6):
    t_leaves = jax.tree_util.tree_leaves(
        torch.utils._pytree.tree_map(
            lambda x: x.detach().numpy() if isinstance(x, torch.Tensor)
            else x, torch_out))
    j_leaves = jax.tree_util.tree_leaves(jax_out)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol,
                                   rtol=1e-6)


def written_args(trace):
    """The argument paths the trace shows updated in place."""
    by = {i.storage: i for i in trace.inputs}
    return sorted(p for p, s in trace.arg_storages if by[s].written)


def _host(seed=0, n=N):
    rng = np.random.default_rng(seed)
    return {"p_w": rng.standard_normal((n, n)).astype(np.float32),
            "p_v": rng.standard_normal((n,)).astype(np.float32),
            "s_w": rng.standard_normal((n, n)).astype(np.float32),
            "s_v": rng.standard_normal((n,)).astype(np.float32),
            "b": rng.standard_normal((4, n)).astype(np.float32)}


def _train_ish_jax(h):
    def step(p, s, b):
        g = jax.tree_util.tree_map(lambda x: x * 0.9, p)
        s2 = jax.tree_util.tree_map(lambda x: x + 1.0, s)
        return g, s2, (b * 2.0).sum()

    p = {"w": jnp.asarray(h["p_w"]), "v": jnp.asarray(h["p_v"])}
    s = {"w": jnp.asarray(h["s_w"]), "v": jnp.asarray(h["s_v"])}
    return step, (p, s, jnp.asarray(h["b"])), p, {"w": P(), "v": P()}


def _train_ish_torch(h):
    """The UNDONATED toy train step: params and state in, their
    replacements out."""
    def step(p, s, b):
        g = {k: x * 0.9 for k, x in p.items()}
        s2 = {k: x + 1.0 for k, x in s.items()}
        return g, s2, (b * 2.0).sum()

    p = {"w": torch.tensor(h["p_w"]), "v": torch.tensor(h["p_v"])}
    s = {"w": torch.tensor(h["s_w"]), "v": torch.tensor(h["s_v"])}
    return step, (p, s, torch.tensor(h["b"])), p


def _jax_copy(args):
    return jax.tree_util.tree_map(lambda x: jnp.array(np.asarray(x)), args)


def _torch_copy(args):
    return torch.utils._pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, args)


@pytest.fixture(scope="module")
def train_ish():
    """Both packages' toy step, fixed once (module-scoped: the JAX
    engine compiles each candidate)."""
    h = _host()
    jstep, jargs, jp, jsh = _train_ish_jax(h)
    jres = janalysis.fix_program(jstep, jargs, params=jp, shardings=jsh,
                                 name="toy")
    tstep, targs, tp = _train_ish_torch(h)
    tres = fix_program(tstep, targs, params=tp, name="toy")
    return h, jres, tres, tstep, targs


class TestDonationFix:
    def test_fix_applies_and_verifies(self, train_ish):
        h, jres, tres, _, _ = train_ish
        same_outcome(jres, tres)
        (a,) = tres.attempts
        assert a.rule_id == "undonated-step-buffers"
        assert a.action == "donate-step-buffers"
        assert a.verified and a.applied and not a.degraded
        assert set(a.proofs) == set(PROOF_KEYS)
        assert all(a.proofs[k]["ok"] for k in PROOF_KEYS)
        # the fixed step updates its state in place: re-lint silent, the
        # trace shows both arguments written (JAX: the module aliased)
        assert not by_rule(tres.findings_after, "undonated-step-buffers")
        assert "tf.aliasing_output" in lowered_stablehlo(jres.lowered)
        assert written_args(tres.lowered) == [
            "args[0]['v']", "args[0]['w']", "args[1]['v']", "args[1]['w']"]
        # the fixed steps compute the same numbers, and the torch one
        # hands its inputs' storage on
        jout = jres.fn(*_jax_copy(jres.example_args))
        targs = _torch_copy(tres.example_args)
        ptr = targs[0]["w"].data_ptr()
        tout = tres.fn(*targs)
        close(tout, jout)
        assert tout[0]["w"].data_ptr() == ptr

    def test_budget_delta_shows_the_peak_drop(self, train_ish):
        _, jres, tres, _, _ = train_ish
        for res in (jres, tres):
            mem = res.attempts[0].proofs["budget_delta"]["memory"]
            assert mem["peak_bytes_after"] < mem["peak_bytes_before"]
            assert mem["peak_bytes_delta"] < 0
        # the traced peak falls by exactly the predicted bytes
        a = tres.attempts[0]
        mem = a.proofs["budget_delta"]["memory"]
        assert -mem["peak_bytes_delta"] == \
            a.fix.predicted_effect["peak_hbm_bytes_saved"] > 0

    def test_numeric_equivalence_checked(self, train_ish):
        _, jres, tres, _, _ = train_ish
        for res in (jres, tres):
            eq = res.attempts[0].proofs["numeric_equivalence"]
            assert eq["ok"] and eq["checked_leaves"] == 5
            assert eq["max_abs_diff"] == 0.0

    def test_clean_program_proposes_nothing(self):
        h = _host()
        jstep, jargs, jp, jsh = _train_ish_jax(h)
        donated = jax.jit(jstep, donate_argnums=(0, 1))
        jres = janalysis.fix_program(donated, jargs, params=jp,
                                     shardings=jsh)

        def step(p, s, b):
            # the torch idiom of a donated step: the state in place
            for x in p.values():
                x.mul_(0.9)
            for x in s.values():
                x.add_(1.0)
            return p, s, (b * 2.0).sum()

        _, targs, tp = _train_ish_torch(h)
        tres = fix_program(step, targs, params=tp)
        for res, fn in ((jres, donated), (tres, step)):
            assert res.report["summary"]["proposed"] == 0
            assert res.fn is fn

    def test_partially_coverable_arg_degrades(self):
        """params has two leaves but only ONE comes back out: donating
        the whole argument is not expressible, so the fix degrades and
        the original WARNING stands."""
        rng = np.random.default_rng(1)
        w, v = (rng.standard_normal((N, N)).astype(np.float32)
                for _ in range(2))

        def jstep(p, b):
            return {"w": p["w"] * 0.9 + p["v"].sum()}, (b * 2.0).sum()

        def tstep(p, b):
            return {"w": p["w"] * 0.9 + p["v"].sum()}, (b * 2.0).sum()

        jp = {"w": jnp.asarray(w), "v": jnp.asarray(v)}
        jres = janalysis.fix_program(jstep, (jp, jnp.ones((4,))), params=jp,
                                     shardings={"w": P(), "v": P()})
        tp = {"w": torch.tensor(w), "v": torch.tensor(v)}
        tres = fix_program(tstep, (tp, torch.ones(4)), params=tp)
        same_outcome(jres, tres)
        (a,) = tres.attempts
        assert a.degraded and not a.applied
        assert "partially coverable" in a.degrade_reason
        assert by_rule(tres.findings_after, "undonated-step-buffers")
        assert tres.fn is tstep

    def test_read_only_twin_does_not_veto_the_coverable_arg(self):
        """A read-only param-shaped input (an EMA copy) has no
        replacement: it is SKIPPED, and does not veto donating the real
        carried state."""
        rng = np.random.default_rng(2)
        w, e = (rng.standard_normal((N, N)).astype(np.float32)
                for _ in range(2))

        def jstep(p, ema, b):
            upd = jax.tree_util.tree_map(
                lambda x, y: x * 0.9 + y.sum() * 0.0, p, ema)
            return upd, (b * 2.0).sum()

        def tstep(p, ema, b):
            upd = {k: p[k] * 0.9 + ema[k].sum() * 0.0 for k in p}
            return upd, (b * 2.0).sum()

        jp, jema = {"w": jnp.asarray(w)}, {"w": jnp.asarray(e)}
        jres = janalysis.fix_program(jstep, (jp, jema, jnp.ones((4,))),
                                     params=jp, shardings={"w": P()})
        tp, tema = {"w": torch.tensor(w)}, {"w": torch.tensor(e)}
        tres = fix_program(tstep, (tp, tema, torch.ones(4)), params=tp)
        same_outcome(jres, tres)
        (a,) = tres.attempts
        assert a.verified and a.applied, a.degrade_reason
        assert a.fix.data["donate_argnums"] == \
            jres.attempts[0].fix.data["donate_argnums"] == [0]
        assert not by_rule(tres.findings_after, "undonated-step-buffers")
        close(tres.fn(*_torch_copy(tres.example_args)),
              jres.fn(*_jax_copy(jres.example_args)))

    def test_dry_run_verifies_without_applying(self):
        h = _host()
        jstep, jargs, jp, jsh = _train_ish_jax(h)
        jres = janalysis.fix_program(jstep, jargs, params=jp, shardings=jsh,
                                     apply=False)
        tstep, targs, tp = _train_ish_torch(h)
        tres = fix_program(tstep, targs, params=tp, apply=False)
        same_outcome(jres, tres)
        (a,) = tres.attempts
        assert a.verified and not a.applied
        assert tres.report["mode"] == "dry-run"
        # the caller's step is untouched, its trace too
        assert tres.fn is tstep
        assert written_args(tres.lowered) == []
        # ...but the verdict previews the repaired step
        assert not by_rule(tres.findings_after, "undonated-step-buffers")

    def test_a_copy_back_donation_is_refused_by_the_budget_proof(
            self, monkeypatch):
        """A 'donation' that writes the outputs into the inputs after the
        step saves nothing (old and new are alive at its peak): proofs 1-3
        hold, proof 4 refuses it, and the step is left as it was."""
        real = fixes._FIXERS["undonated-step-buffers"]

        def copy_back(ctx, findings, env):
            fix, _ = real(ctx, findings, env)

            def transform(fn, example_args):
                def fixed(p, s, b):
                    g, s2, loss = fn(p, s, b)
                    with torch.no_grad():
                        for k in p:
                            p[k].copy_(g[k])
                            s[k].copy_(s2[k])
                    return p, s, loss

                return fixed, example_args

            return fix, transform

        monkeypatch.setitem(fixes._FIXERS, "undonated-step-buffers",
                            copy_back)
        tstep, targs, tp = _train_ish_torch(_host())
        res = fix_program(tstep, targs, params=tp)
        (a,) = res.attempts
        assert a.degraded and not a.applied and res.fn is tstep
        assert all(a.proofs[k]["ok"] for k in PROOF_KEYS[:3])
        budget = a.proofs["budget_delta"]
        assert not budget["ok"] and "short of the predicted" in \
            budget["reason"]
        assert by_rule(res.findings_after, "undonated-step-buffers")


def _later_read(p, b):
    new = {"w": p["w"] * 0.9}
    return new, (p["w"] * b).sum()      # reads p["w"] after new["w"]


def _grad_leaf(p, b):
    return {"w": p["w"] * 0.9}, b.sum()


def _read_at_run(p, b):
    # the real run reads the input after its replacement; the trace not
    new = {"w": p["w"] * 0.9}
    if p["w"].is_meta:
        return new, b.sum()
    return new, (p["w"] * b).sum()


def _mismatch(p, b):
    # the real run takes another op than the (meta) trace's
    if p["w"].is_meta:
        return {"w": p["w"] * 0.9}, b.sum()
    return {"w": p["w"].div(1 / 0.9)}, b.sum()


@pytest.mark.parametrize("case", ["later_read", "view", "alias",
                                  "grad_leaf", "op_sequence",
                                  "read_at_run"])
def test_the_donation_plan_degrades_where_it_cannot_hold(case):
    """Each case the donation must refuse: a read of the input after its
    replacement is made, an input that is a view or shares storage with
    another input, a leaf that autograd needs, a real run whose op
    sequence misses the plan or reads a donated input after its write
    (the trace did neither). The step comes back as it was."""
    w = torch.randn(N, N, generator=torch.Generator().manual_seed(3))
    b = torch.ones(N)
    step, p = _grad_leaf, {"w": w}
    if case == "later_read":
        step = _later_read
    elif case == "view":
        p = {"w": torch.cat([w, w])[:N]}
    elif case == "alias":
        def step(p, q, b):
            return {"w": p["w"] * 0.9}, (q * b).sum()

        for q in (w, w.detach()):
            res = fix_program(step, ({"w": w}, q, b), params={"w": w})
            (a,) = res.attempts
            assert a.degraded and "shares its storage" in a.degrade_reason
            assert res.fn is step
        return
    elif case == "grad_leaf":
        p = {"w": w.clone().requires_grad_()}
    elif case == "op_sequence":
        step = _mismatch
    elif case == "read_at_run":
        step = _read_at_run
    res = fix_program(step, (p, b), params={"w": w})
    (a,) = res.attempts
    assert a.degraded and not a.applied and res.fn is step
    want = {"later_read": "no replacement made after its last read",
            "view": "is a view", "grad_leaf": "autograd still needs",
            "op_sequence": "numeric_equivalence",
            "read_at_run": "numeric_equivalence"}[case]
    assert want in a.degrade_reason
    if case in ("op_sequence", "read_at_run"):
        assert {"op_sequence": "op sequence differs",
                "read_at_run": "reads a donated input"}[case] in \
            a.proofs["numeric_equivalence"]["reason"]


class TestManualDonationSeam:
    def test_lower_train_step_donate_argnums(self):
        """The manual seam for a donate-step-buffers fix: the argnums fed
        to lower_train_step give a trace that updates them in place, and
        the donated step it hands on computes the same."""
        from sparkdl_tpu.parallel.train import lower_train_step as jlower
        from sparkdl_tpu_torch.parallel.train import lower_train_step

        h = _host()
        jstep, jargs, _, _ = _train_ish_jax(h)
        jdonated = jlower(jax.jit(jstep), *jargs, donate_argnums=(0, 1))
        assert "tf.aliasing_output" in lowered_stablehlo(jdonated)
        tstep, targs, _ = _train_ish_torch(h)
        plain = lower_train_step(tstep, *targs, cost_name=None)
        assert written_args(plain) == []
        donated = lower_train_step(tstep, *targs, donate_argnums=(0, 1),
                                   cost_name=None)
        assert written_args(donated) == [
            "args[0]['v']", "args[0]['w']", "args[1]['v']", "args[1]['w']"]
        assert donated.static_budget_bytes() < plain.static_budget_bytes()
        close(donated.step(*_torch_copy(targs)),
              jax.jit(jstep)(*_jax_copy(jargs)))
        with pytest.raises(ValueError, match="argument"):
            lower_train_step(tstep, *targs, donate_argnums=(2,),
                             cost_name=None)


class TestScalarHoistFix:
    def test_top_level_scalar_hoisted(self):
        x = np.random.default_rng(4).standard_normal(8).astype(np.float32)
        jres = janalysis.fix_program(lambda x, lr: x * lr,
                                     (jnp.asarray(x), 0.5), name="scalar")

        def f(x, lr):
            return x * lr

        tres = fix_program(f, (torch.tensor(x), 0.5), name="scalar")
        same_outcome(jres, tres)
        (a,) = tres.attempts
        assert a.action == "hoist-weak-scalar"
        assert a.verified and a.applied
        assert all(a.proofs[k]["ok"] for k in PROOF_KEYS)
        # the scalar left the signature and the payload
        assert len(tres.example_args) == 1
        assert not by_rule(tres.findings_after, "host-sync-in-step")
        assert "torch.float32" not in a.fix.description
        assert "float32" in a.fix.description
        out = tres.fn(torch.full((8,), 3.0))
        assert out.dtype == torch.float32
        close(out, jres.fn(jnp.full((8,), 3.0)))

    def test_surviving_callback_lands_in_unfixable(self):
        """A card read (the JAX package's host callback) shares the
        hoistable scalar's rule id but survives the hoist: it lands in
        the report's unfixable bucket (by identity, not rule)."""
        def jf(x, lr):
            jax.debug.print("sum {}", x.sum())
            return x * lr

        def tf(x, lr):
            print("sum", x.sum().item())
            return x * lr

        jres = janalysis.fix_program(jf, (jnp.ones((8,)), 0.5))
        tres = fix_program(tf, (torch.ones(8), 0.5))
        same_outcome(jres, tres)
        (a,) = tres.attempts
        assert a.applied, a.degrade_reason
        survivors = by_rule(tres.findings_after, "host-sync-in-step")
        assert survivors and survivors[0].severity == Severity.ERROR
        unfix_ops = {u["op"] for u in tres.report["unfixable"]}
        assert any(op not in ("int", "float") for op in unfix_ops)

    def test_nested_scalar_degrades(self):
        jres = janalysis.fix_program(lambda d: d["x"] * d["lr"],
                                     ({"x": jnp.ones((8,)), "lr": 0.5},))

        def g(d):
            return d["x"] * d["lr"]

        tres = fix_program(g, ({"x": torch.ones(8), "lr": 0.5},))
        same_outcome(jres, tres)
        (a,) = tres.attempts
        assert a.degraded and not a.applied
        assert "nested" in a.degrade_reason
        assert by_rule(tres.findings_after, "host-sync-in-step")


class TestNarrow64BitFix:
    def test_f64_arg_narrowed_with_explicit_cast(self):
        x = np.random.default_rng(5).standard_normal(8)

        def h(x):
            return x + 1.0

        jres = janalysis.fix_program(h, (x,))
        tres = fix_program(h, (torch.tensor(x),))
        same_outcome(jres, tres)
        (a,) = tres.attempts
        assert a.action == "narrow-64bit-payload"
        assert a.verified and a.applied
        assert all(a.proofs[k]["ok"] for k in PROOF_KEYS)
        assert tres.example_args[0].dtype == torch.float32
        assert not by_rule(tres.findings_after, "silent-canonicalization")
        # against the float64 original, within float32's 64 eps (JAX's
        # canonicalizing original is float32 already: 0.0)
        assert a.proofs["numeric_equivalence"]["max_abs_diff"] < 1e-6
        close(tres.fn(*tres.example_args), jres.fn(*jres.example_args))

    def test_int64_roundtrip_ok_narrowed(self):
        """JAX narrows an int64 that round-trips; torch's pass never
        flags int64 (its index dtype): nothing proposed, the argument
        stays int64, the step as it was."""
        def h(x):
            return x + 1

        x = np.array([3, 7], np.int64)
        jres = janalysis.fix_program(h, (x,))
        (ja,) = jres.attempts
        assert ja.verified and ja.applied
        assert np.asarray(jres.example_args[0]).dtype == np.int32
        tres = fix_program(h, (torch.tensor(x),))
        assert tres.attempts == [] and tres.fn is h
        assert tres.example_args[0].dtype == torch.int64
        assert not by_rule(tres.findings_before, "silent-canonicalization")

    def test_int64_overflow_degrades_to_the_error(self):
        """JAX degrades on an int64 that does not round-trip (the ERROR
        stands); in torch the value is no fault and nothing is flagged."""
        def h(x):
            return x + 1

        x = np.array([2 ** 40], np.int64)
        jres = janalysis.fix_program(h, (x,))
        (ja,) = jres.attempts
        assert ja.degraded and "round-trip" in ja.degrade_reason
        tres = fix_program(h, (torch.tensor(x),))
        assert tres.report["summary"]["proposed"] == 0
        assert not tres.findings_after
        assert int(tres.fn(*tres.example_args)[0]) == 2 ** 40 + 1


class TestFixitReport:
    def test_schema_and_proof_shape(self, train_ish):
        _, jres, tres, _, _ = train_ish
        assert FIXIT_SCHEMA == jfixes.FIXIT_SCHEMA
        rep = tres.report
        assert rep["schema"] == FIXIT_SCHEMA
        assert rep["mode"] == "apply"
        assert rep["summary"]["proposed"] == rep["summary"]["applied"] == 1
        (fx,) = rep["fixes"]
        assert set(fx["proofs"]) == set(PROOF_KEYS)
        assert fx["fix"]["preconditions"]
        assert fx["fix"]["predicted_effect"]["peak_hbm_bytes_saved"] > 0
        assert fx["fix"]["data"]["donate_argnums"] == \
            jres.report["fixes"][0]["fix"]["data"]["donate_argnums"] == \
            [0, 1]
        json.dumps(rep)
        assert key_tree(rep) == key_tree(jres.report)

    def test_every_fixable_rule_has_an_action(self):
        assert {r: a for r, (a, _) in FIX_ACTIONS.items()} == \
            {r: a for r, (a, _) in jfixes.FIX_ACTIONS.items()}
        assert fixes._ACTION_ORDER == jfixes._ACTION_ORDER

    def test_render_text_mentions_state_and_proofs(self, train_ish):
        _, _, tres, _, _ = train_ish
        text = render_fixit_text(tres.report)
        assert "[applied]" in text
        assert "donate-step-buffers" in text
        assert "proofs:" in text


class TestComposition:
    def test_all_three_rules_fixed_in_one_pass(self):
        """A step tripping every fixable rule at once (a 64-bit argument,
        a Python-scalar argument AND undonated carried state): the engine
        narrows, then hoists, then donates, each verified against the
        step before it, and the final step is clean of all three."""
        rng = np.random.default_rng(6)
        w = rng.standard_normal((N, N)).astype(np.float32)
        b64 = rng.standard_normal((4, N))

        def jstep(p, b, lr):
            return (jax.tree_util.tree_map(lambda x: x * lr, p),
                    (b * 2.0).sum())

        def tstep(p, b, lr):
            return {k: x * lr for k, x in p.items()}, (b * 2.0).sum()

        jp = {"w": jnp.asarray(w)}
        jres = janalysis.fix_program(jstep, (jp, b64, 0.5), params=jp,
                                     shardings={"w": P()})
        tp = {"w": torch.tensor(w)}
        tres = fix_program(tstep, (tp, torch.tensor(b64), 0.5), params=tp)
        same_outcome(jres, tres)
        by_action = {a.action: a for a in tres.attempts}
        assert set(by_action) == {"narrow-64bit-payload",
                                  "hoist-weak-scalar",
                                  "donate-step-buffers"}
        for a in tres.attempts:
            assert a.verified and a.applied, (a.action, a.degrade_reason)
        assert not tres.findings_after
        assert len(tres.example_args) == 2
        assert tres.example_args[1].dtype == torch.float32
        assert written_args(tres.lowered) == ["args[0]['w']"]
        assert tres.report["summary"]["applied"] == 3
        close(tres.fn(*_torch_copy(tres.example_args)),
              jres.fn(*_jax_copy(jres.example_args)), atol=1e-5)


# -- the pre-flight's fix switch ----------------------------------------------


class _WorkerSpawned(Exception):
    """Tripwire: the launcher reached subprocess.Popen."""


@pytest.fixture
def fix_on(monkeypatch, tmp_path):
    from sparkdl_tpu_torch import observe
    from sparkdl_tpu_torch.analysis import preflight
    from sparkdl_tpu_torch.horovod import launcher, supervisor

    real = launcher.subprocess.Popen

    def boom(*a, **k):
        # only a worker trips it: the telemetry's write runs git
        if "sparkdl_tpu_torch.horovod._worker" in " ".join(map(str, a[0])):
            raise _WorkerSpawned(a[0])
        return real(*a, **k)

    monkeypatch.setattr(preflight, "ENABLED", True)
    monkeypatch.setattr(preflight, "FIX", True)
    monkeypatch.setattr(launcher.subprocess, "Popen", boom)
    monkeypatch.setattr(supervisor, "policy", supervisor.RetryPolicy())
    monkeypatch.setattr(observe, "TELEMETRY_DIR", str(tmp_path))
    observe._reset_for_tests()
    preflight.clear()
    yield preflight
    preflight.clear()
    observe._reset_for_tests()


def _noop_main():
    return 0


def test_preflight_fix_replaces_the_step_and_writes_its_report(
        fix_on, tmp_path):
    """With ENABLED and FIX, a registered functional step goes through
    the fix engine before any worker spawns: the verified donation
    replaces the registered entry, and its report lands in the gang's run
    directory as fixit_report.json, which observe.doctor renders."""
    import glob
    import os

    from sparkdl_tpu_torch import HorovodRunner
    from sparkdl_tpu_torch.observe import doctor

    tstep, targs, tp = _train_ish_torch(_host())
    fix_on.register_preflight(tstep, *targs, params=tp)
    assert fix_on.fix_enabled()
    with pytest.raises(_WorkerSpawned):
        HorovodRunner(np=-2).run(_noop_main)
    (entry,) = fix_on._REGISTERED
    assert isinstance(entry[0], fixes.DonatedStep) and entry[0].func is tstep
    assert fix_on.take_fixit_reports() == []     # drained by the launcher
    (run,) = glob.glob(str(tmp_path / "run-*"))
    with open(os.path.join(run, "fixit_report.json")) as f:
        (report,) = json.load(f)["reports"]
    assert report["schema"] == FIXIT_SCHEMA
    assert report["summary"]["applied"] == 1
    diag = doctor.diagnose(run)
    (rep,) = diag["fixit"]["reports"]
    assert rep["fixes"][0]["action"] == "donate-step-buffers"
    text = doctor.render_text(diag)
    assert "[applied] undonated-step-buffers -> donate-step-buffers" in text


def test_preflight_without_fix_leaves_the_step(fix_on, monkeypatch):
    """FIX off: the step is linted as registered, no fixit report."""
    from sparkdl_tpu_torch import HorovodRunner

    monkeypatch.setattr(fix_on, "FIX", False)
    tstep, targs, tp = _train_ish_torch(_host())
    fix_on.register_preflight(tstep, *targs, params=tp)
    with pytest.raises(_WorkerSpawned):
        HorovodRunner(np=-2).run(_noop_main)
    assert fix_on._REGISTERED[0][0] is tstep
    assert fix_on.take_fixit_reports() == []


def test_preflight_fix_lints_a_trace_unfixed_and_local_mode_drains(
        fix_on, caplog):
    """A registered Trace has no step to rewrite: linted as it is, with a
    warning. Local mode (np=-1) drains the reports (no run directory)."""
    from sparkdl_tpu_torch import HorovodRunner
    from sparkdl_tpu_torch.parallel.train import lower_train_step

    tstep, targs, tp = _train_ish_torch(_host())
    fix_on.register_preflight(lower_train_step(tstep, *targs,
                                               cost_name=None))
    with pytest.raises(_WorkerSpawned):
        HorovodRunner(np=-2).run(_noop_main)
    assert "has no step to rewrite" in caplog.text
    fix_on.clear()
    fix_on.register_preflight(tstep, *targs, params=tp)
    assert HorovodRunner(np=-1).run(_noop_main) == 0
    assert fix_on.take_fixit_reports() == []
    assert isinstance(fix_on._REGISTERED[0][0], fixes.DonatedStep)
