"""The port's gang supervisor against the JAX package's on the CPU: the
failure classifier on every case of tests/horovod/test_fault_tolerance.py
and on torch.distributed's own failure vocabulary, the backoff schedule,
and supervise() on scripted launches (the attempt numbers and resume
steps it hands each relaunch, what it raises, its attempt log). No
process is spawned."""

import signal

import pytest
import torch

from sparkdl_tpu.horovod import launcher as jax_launcher
from sparkdl_tpu.horovod import supervisor as jax_sup
from sparkdl_tpu_torch.horovod import RestartContext, restart_context
from sparkdl_tpu_torch.horovod import launcher as pt_launcher
from sparkdl_tpu_torch.horovod import supervisor as pt_sup

torch.set_num_threads(2)

SIGKILL = -signal.SIGKILL


def _tb(terminal):
    return ("Traceback (most recent call last):\n"
            '  File "/u/train.py", line 9, in main\n'
            "    step(batch)\n" + terminal)


# (name, kind, exit codes, {rank: traceback}) as GangFailure fields: the
# cases of tests/horovod/test_fault_tolerance.py (classification taxonomy)
GANG_CASES = [
    ("signal_death", "worker_death", [0, SIGKILL], {}),
    ("user_exception_with_killed_survivors", "worker_death", [1, SIGKILL],
     {0: _tb("ValueError: bad hyperparameter")}),
    ("infra_exception", "worker_death", [1, SIGKILL],
     {0: _tb("jaxlib.xla_extension.XlaRuntimeError: UNKNOWN: Gloo "
             "allreduce failed: Connection closed by peer [127.0.0.1]")}),
    ("infra_vocabulary_in_user_frames", "worker_death", [1, 0],
     {0: 'Traceback (most recent call last):\n'
         '  File "/home/u/gloo_utils.py", line 9, in rendezvous_data\n'
         '    raise ValueError("bad shard spec")\n'
         'ValueError: bad shard spec'}),
    ("rendezvous_timeout", "rendezvous_timeout", [], {}),
    ("lost_result", "no_result", [], {}),
    ("port_clash", "start_failure", [1, 0],
     {0: _tb("RuntimeError: Failed to initialize coordinator: Address "
             "already in use")}),
    ("unclassified_worker_exit", "worker_death", [1, 0], {}),
    ("operator_pattern_unset", "worker_death", [1],
     {0: "FrobnicationError: ICI link flapped on chip 3"}),
    ("job_timeout", "job_timeout", [0, 0], {}),
]


@pytest.mark.parametrize("kind,codes,excs", [c[1:] for c in GANG_CASES],
                         ids=[c[0] for c in GANG_CASES])
def test_gang_failures_classify_as_in_jax(kind, codes, excs):
    ref = jax_sup.classify_failure(jax_sup.GangFailure(
        "x", kind=kind, exit_codes=codes, exceptions=excs))
    got = pt_sup.classify_failure(pt_sup.GangFailure(
        "x", kind=kind, exit_codes=codes, exceptions=excs))
    assert got == ref


@pytest.mark.parametrize("exc", [
    jax_launcher.SlotExhaustionError("np too big"),
    jax_launcher.SlotProbeError("probe died"),
    jax_launcher.SlotWaitTimeout("gave up"),
    ValueError("per_rank_kwargs mismatch"),
    TypeError("np must be an int"),
    KeyError("x"),
], ids=lambda e: type(e).__name__)
def test_typed_errors_classify_as_in_jax(exc):
    ref = jax_sup.classify_failure(exc)
    assert ref[0] == jax_sup.PERMANENT
    assert pt_sup.classify_failure(exc)[0] == pt_sup.PERMANENT
    if isinstance(exc, jax_launcher.SlotExhaustionError):
        port = pt_launcher.SlotExhaustionError("np too big")
        assert pt_sup.classify_failure(port) == ref


def test_operator_patterns_are_a_policy_field(monkeypatch):
    tb = "FrobnicationError: ICI link flapped on chip 3"
    kw = {"kind": "worker_death", "exit_codes": [1], "exceptions": {0: tb}}
    monkeypatch.setenv("SPARKDL_TPU_TRANSIENT_PATTERNS",
                       "ici link flapped; other signature")
    ref = jax_sup.classify_failure(jax_sup.GangFailure("x", **kw))
    assert ref[0] == jax_sup.TRANSIENT
    gf = pt_sup.GangFailure("x", **kw)
    # the port reads no environment variable
    assert pt_sup.classify_failure(gf)[0] == pt_sup.PERMANENT
    assert pt_sup.classify_failure(
        gf, ("ICI link flapped", "other signature")) == ref


# torch.distributed's failures, as a survivor's terminal block shows them
TORCH_INFRA = {
    "gloo_peer_closed": "RuntimeError: [/pytorch/third_party/gloo/gloo/"
    "transport/tcp/pair.cc:553] Connection closed by peer "
    "[127.0.0.1]:15030. This is typically caused by a remote worker "
    "crashing.",
    "gloo_peer_reset": "RuntimeError: [/pytorch/third_party/gloo/gloo/"
    "transport/tcp/pair.cc:537] Read error [127.0.0.1]:50585: Connection "
    "reset by peer.",
    "gloo_recv_timeout": "torch.distributed.DistBackendError: [/pytorch/"
    "third_party/gloo/gloo/transport/tcp/unbound_buffer.cc:81] Timed out "
    "waiting 1800000ms for recv operation to complete",
    "dist_network_error": "torch.distributed.DistNetworkError: The client "
    "socket has timed out after 300000ms while trying to connect to "
    "(127.0.0.1, 29500).",
    "dist_store_timeout": "torch.distributed.DistStoreError: Timed out "
    "after 301 seconds waiting for clients. 1/2 clients joined.",
    "dist_store_wait_timeout": "torch.distributed.DistStoreError: wait "
    "timeout after 300000ms, keys: /default_pg/0//cuda//0",
    "nccl_remote_error": "torch.distributed.DistBackendError: NCCL error "
    "in: /pytorch/torch/csrc/distributed/c10d/ProcessGroupNCCL.cpp:1970, "
    "remote process exited or there was a network error, NCCL version "
    "2.21.5\nncclRemoteError: A call failed possibly due to a network "
    "error or a remote process exiting prematurely.\nLast error:\n"
    "NET/IB : Got completion from peer 10.0.0.2<43210> with status=5",
    "nccl_comm_aborted": "torch.distributed.DistBackendError: NCCL "
    "communicator was aborted on rank 0.",
    "broken_pipe": "BrokenPipeError: [Errno 32] Broken pipe",
    "port_clash_store": "torch.distributed.DistNetworkError: The server "
    "socket has failed to listen on any local network address. port: "
    "29500, useIpv6: false, code: -98, name: EADDRINUSE, message: "
    "address already in use",
}

# misuse, which a relaunch reproduces
TORCH_MISUSE = {
    "nccl_invalid_usage": "torch.distributed.DistBackendError: NCCL error "
    "in: /pytorch/torch/csrc/distributed/c10d/ProcessGroupNCCL.cpp:3356, "
    "invalid usage (run with NCCL_DEBUG=WARN for details), NCCL version "
    "2.21.5\nncclInvalidUsage: This usually reflects invalid usage of "
    "NCCL library.",
    "gloo_size_mismatch": "RuntimeError: [enforce fail at /pytorch/"
    "third_party/gloo/gloo/transport/tcp/pair.cc:456] op.preamble.length "
    "<= op.nbytes. 8 vs 4. Received data size doesn't match expected "
    "size. Is there a distributed collective mismatch in your code?",
    "dist_store_key_error": "torch.distributed.DistStoreError: "
    "compare_set: the store holds no such key",
}


def test_terminal_block_is_the_last_exception_with_its_whole_message():
    chained = (
        _tb("ConnectionResetError: [Errno 104] Connection reset by peer")
        + "\n\nDuring handling of the above exception, another exception "
        "occurred:\n\n" + _tb("ValueError: bad retry setting\nsecond "
                               "line of the message"))
    assert pt_sup._terminal_block(chained) == (
        "ValueError: bad retry setting\nsecond line of the message")
    assert not pt_sup._is_infra_traceback(chained)
    nccl = _tb(TORCH_INFRA["nccl_remote_error"])
    assert pt_sup._terminal_block(nccl).startswith(
        "torch.distributed.DistBackendError: NCCL error in:")
    assert pt_sup._terminal_block("FrobError: x") == "FrobError: x"


def _failure(terminal):
    return pt_sup.GangFailure("x", kind="worker_death",
                              exit_codes=[1, SIGKILL],
                              exceptions={0: _tb(terminal)})


@pytest.mark.parametrize("name", sorted(TORCH_INFRA))
def test_torch_distributed_failures_are_transient(name):
    verdict, cause = pt_sup.classify_failure(_failure(TORCH_INFRA[name]))
    assert verdict == pt_sup.TRANSIENT, cause
    assert "sig 9" in cause


@pytest.mark.parametrize("name", sorted(TORCH_MISUSE))
def test_torch_distributed_misuse_is_permanent(name):
    verdict, cause = pt_sup.classify_failure(_failure(TORCH_MISUSE[name]))
    assert verdict == pt_sup.PERMANENT
    assert "rank(s) [0]" in cause


def test_gloo_misuse_is_where_the_port_parts_from_jax():
    """The JAX list matches the bare word "gloo", which torch's gloo puts
    in every enforce failure, misuse included; the port does not."""
    excs = {0: _tb(TORCH_MISUSE["gloo_size_mismatch"])}
    ref = jax_sup.classify_failure(jax_sup.GangFailure(
        "x", kind="worker_death", exit_codes=[1, SIGKILL], exceptions=excs))
    assert ref[0] == jax_sup.TRANSIENT
    assert "gloo" not in pt_sup.TRANSIENT_SIGNATURES
    assert {"coordination service", "heartbeat"}.isdisjoint(
        pt_sup.TRANSIENT_SIGNATURES)


def test_backoff_equals_jax():
    kw = dict(max_retries=8, backoff_base=0.5, backoff_factor=2.0,
              backoff_max=20.0, jitter=0.5)
    ref, got = jax_sup.RetryPolicy(**kw), pt_sup.RetryPolicy(**kw)
    for attempt in range(1, 9):
        for r in (0.0, 0.37, 1.0):
            assert (got.backoff(attempt, _random=lambda: r)
                    == ref.backoff(attempt, _random=lambda: r))
    assert got.backoff(8, _random=lambda: 0.0) == 20.0  # capped


def _script(outcomes, sup, tmp_path, seen):
    """A launch that records what it was handed, commits a checkpoint
    step, and then fails or returns as ``outcomes`` says."""

    def launch(arg):
        seen.append(arg)
        n = len(seen)
        (tmp_path / str(10 * n)).mkdir()
        (tmp_path / f"{10 * n + 5}.tmp-1").mkdir()  # never committed
        what = outcomes[n - 1]
        if what == "transient":
            raise sup.GangFailure("preempted", kind="worker_death",
                                  exit_codes=[0, SIGKILL])
        if what == "user":
            raise sup.GangFailure(
                "user bug", kind="worker_death", exit_codes=[1, SIGKILL],
                exceptions={0: _tb("ValueError: user bug")})
        return f"done after {n}"

    return launch


def _from_env(env):
    step = env.get(jax_sup.RESUME_STEP_ENV)
    return (int(env.get(jax_sup.RESTART_ATTEMPT_ENV, "0")),
            None if step is None else int(step))


def _run(sup, policy_kw, outcomes, tmp_path):
    seen, sleeps = [], []
    root = tmp_path / sup.__name__.split(".")[0]
    root.mkdir()
    policy = sup.RetryPolicy(resume_dir=str(root), **policy_kw)
    try:
        out = sup.supervise(_script(outcomes, sup, root, seen), policy,
                            _sleep=sleeps.append)
    except Exception as e:  # noqa: BLE001 - compared below
        out = e
    if sup is jax_sup:
        seen = [_from_env(env) for env in seen]
    else:
        seen = [(ctx.attempt, ctx.resume_step) for ctx in seen]
    return out, seen, sleeps


@pytest.mark.parametrize("policy_kw,outcomes", [
    ({"max_retries": 3, "backoff_base": 0.25, "jitter": 0.0},
     ["transient", "transient", "ok"]),
    ({"max_retries": 3}, ["user"]),
    ({"max_retries": 2, "backoff_base": 0.1, "jitter": 0.0},
     ["transient"] * 3),
    ({"max_retries": 0}, ["transient"]),
    ({"max_retries": 2, "backoff_base": 0.0}, ["transient", "user"]),
], ids=["recovers", "permanent", "exhausted", "supervision_off",
        "permanent_after_relaunch"])
def test_supervise_hands_relaunches_what_jax_ships(policy_kw, outcomes,
                                                   tmp_path):
    ref, ref_seen, ref_sleeps = _run(jax_sup, policy_kw, outcomes, tmp_path)
    got, seen, sleeps = _run(pt_sup, policy_kw, outcomes, tmp_path)
    assert seen == ref_seen
    assert sleeps == ref_sleeps
    assert seen[0] == (0, None)
    assert [s for _, s in seen[1:]] == [10 * n for n in range(1, len(seen))]
    if isinstance(ref, str):
        assert got == ref
        return
    assert type(got).__name__ == type(ref).__name__
    assert str(got).splitlines()[0] == str(ref).splitlines()[0]
    if isinstance(ref, jax_sup.GangRetryBudgetExhausted):
        assert got.budget == ref.budget
        assert ([(a.number, a.verdict, a.cause) for a in got.attempts]
                == [(a.number, a.verdict, a.cause) for a in ref.attempts])
        assert str(got) == str(ref)
    else:
        assert isinstance(got, pt_sup.GangFailure)


def test_restart_context_outside_a_gang_is_the_first_attempt():
    assert restart_context() == (0, None, None, None)
    assert restart_context() == RestartContext(0, None)


def test_np_beyond_the_cards_is_a_permanent_slot_exhaustion(monkeypatch):
    """Raised before any worker exists, once, whatever the policy."""
    from sparkdl_tpu_torch import HorovodRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pt_sup, "policy", pt_sup.RetryPolicy(max_retries=3))
    calls = []
    real = pt_launcher._resolve_num_workers
    monkeypatch.setattr(pt_launcher, "_resolve_num_workers",
                        lambda np_arg: calls.append(np_arg) or real(np_arg))
    with pytest.raises(pt_launcher.SlotExhaustionError,
                       match="one worker a CUDA card") as exc:
        HorovodRunner(np=2).run(lambda: None)
    assert isinstance(exc.value, RuntimeError)
    assert calls == [2]
    assert pt_sup.classify_failure(exc.value)[0] == pt_sup.PERMANENT
