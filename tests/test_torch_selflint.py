"""The port's pickling-contract lint against the JAX package's: the lint
sources of ``tests/analysis/test_selflint.py`` give the same findings
(rule, op, line and severity) through both linters — a source holding a
module-level jax array spelled for the port with a CUDA tensor on the
same lines, where the JAX rule looks for ``jnp`` constructors and the
port's for ``device=`` a CUDA device, ``.cuda()`` or ``.to(<cuda>)``.
Then the port's own spellings and its surface (``sparkdl_tpu_torch/``
and ``chip_smoke.py``) staying clean."""

import textwrap

import pytest
import torch

from sparkdl_tpu.analysis import selflint as jax_selflint
from sparkdl_tpu_torch.analysis import Severity
from sparkdl_tpu_torch.analysis.selflint import (
    ALLOW_COMMENT,
    RULE_ID,
    lint_paths,
    lint_source,
    self_targets,
)

torch.set_num_threads(2)

VIOLATION_SPARK = textwrap.dedent("""
    from pyspark.sql import SparkSession
    from sparkdl_tpu import HorovodRunner

    spark = SparkSession.builder.appName("x").getOrCreate()

    def main():
        return spark.read.parquet("/data").count()

    HorovodRunner(np=4).run(main)
""")

VIOLATION_JAX_ARRAY = textwrap.dedent("""
    import jax.numpy as jnp
    from sparkdl_tpu import HorovodRunner

    table = jnp.zeros((1024, 1024))

    def main():
        return float((table * 2).sum())

    runner = HorovodRunner(np=2)
    runner.run(main)
""")

CLEAN = textwrap.dedent("""
    from sparkdl_tpu import HorovodRunner

    def main():
        from pyspark.sql import SparkSession
        import jax.numpy as jnp
        spark = SparkSession.builder.getOrCreate()
        table = jnp.zeros((4,))
        return float(table.sum())

    HorovodRunner(np=2).run(main)
""")

CLEAN_UNREACHABLE = textwrap.dedent("""
    from pyspark.sql import SparkSession
    from sparkdl_tpu import HorovodRunner

    spark = SparkSession.builder.getOrCreate()

    def report():
        return spark.version

    def main():
        return 42

    HorovodRunner(np=2).run(main)
""")

SOURCES = {
    "spark": VIOLATION_SPARK,
    "jax-array": VIOLATION_JAX_ARRAY,
    "clean": CLEAN,
    "unreachable": CLEAN_UNREACHABLE,
    "suppressed-on-def": VIOLATION_SPARK.replace(
        'spark = SparkSession.builder.appName("x").getOrCreate()',
        'spark = SparkSession.builder.appName("x").getOrCreate()'
        '  # sparkdl: allow-capture'),
    "suppressed-on-load": VIOLATION_SPARK.replace(
        'return spark.read.parquet("/data").count()',
        'return spark.read.parquet("/data").count()'
        '  # sparkdl: allow-capture'),
    "unrelated-comment": VIOLATION_SPARK.replace(
        'spark = SparkSession.builder.appName("x").getOrCreate()',
        'spark = SparkSession.builder.appName("x").getOrCreate()'
        '  # TODO tidy'),
    "syntax-error": "def broken(:\n",
}

# the port's spelling of a source, line for line
PORT_SPELLING = (
    ("from sparkdl_tpu import", "from sparkdl_tpu_torch import"),
    ("import jax.numpy as jnp", "import torch"),
    ("table = jnp.zeros((1024, 1024))",
     'table = torch.zeros((1024, 1024), device="cuda")'),
    ("table = jnp.zeros((4,))", 'table = torch.zeros((4,), device="cuda")'),
)


def _key(f):
    return (f.rule_id, f.op, f.location.rsplit(":", 1)[1], int(f.severity))


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_same_findings_through_both_linters(name):
    src = SOURCES[name]
    port_src = src
    for a, b in PORT_SPELLING:
        port_src = port_src.replace(a, b)
    want = [_key(f) for f in jax_selflint.lint_source(src, "viol.py")]
    got = lint_source(port_src, "viol.py")
    assert [_key(f) for f in got] == want
    if name == "jax-array":
        (f,) = got
        assert f.op == "table" and "device buffers" in f.message


@pytest.mark.parametrize("spelling", [
    'torch.zeros(4, device="cuda:0")',
    "torch.ones(3, device=torch.device('cuda', 1))",
    "torch.ones(3).cuda()",
    "torch.ones(3).to('cuda')",
    "torch.ones(3).to(DEV)",
])
def test_cuda_tensor_spellings_are_flagged(spelling):
    src = textwrap.dedent(f"""
        import torch
        from sparkdl_tpu_torch import HorovodRunner
        DEV = torch.device("cuda")
        t = {spelling}
        def main():
            return t.sum().item()
        HorovodRunner(np=2).run(main)
    """)
    (f,) = lint_source(src, "m.py")
    assert (f.rule_id, f.op, f.severity) == (RULE_ID, "t", Severity.ERROR)
    assert f.location == "m.py:7"


@pytest.mark.parametrize("spelling", [
    "torch.zeros(4)", 'torch.zeros(4, device="cpu")',
    "torch.ones(3).to(torch.float16)", 'torch.ones(3).to("cpu")',
])
def test_host_tensors_are_not(spelling):
    src = textwrap.dedent(f"""
        import torch
        from sparkdl_tpu_torch import HorovodRunner
        t = {spelling}
        def main():
            return t.sum().item()
        HorovodRunner(np=2).run(main)
    """)
    assert lint_source(src, "m.py") == []


def test_allow_comment_and_lint_paths(tmp_path):
    assert ALLOW_COMMENT == jax_selflint.ALLOW_COMMENT
    bad = VIOLATION_SPARK.replace("sparkdl_tpu", "sparkdl_tpu_torch")
    (tmp_path / "bad.py").write_text(bad)
    (tmp_path / "ok.py").write_text(CLEAN)
    findings = lint_paths([tmp_path, tmp_path / "bad.py"])
    assert len(findings) == 1  # each file once
    assert findings[0].location.startswith(str(tmp_path / "bad.py"))


def test_port_surface_is_clean():
    targets = self_targets()
    assert [t.name for t in targets] == ["sparkdl_tpu_torch", "chip_smoke.py"]
    findings = [f for f in lint_paths(targets)
                if f.severity >= Severity.ERROR]
    assert findings == [], "\n".join(map(str, findings))
