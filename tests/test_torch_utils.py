"""The port's utils (simplemath_tpu_torch/utils/) and the kernels'
``torch.library`` ops (ops/library.py), on the CPU.  Twins of
tests/test_utils.py: the same checks, the export ones with the artifact of
``torch.export``; the solver step at the JAX test's size (batch 4, H=10, 2
iterations) against the port's live solve (``rtol=1e-6, atol=1e-7``, as
there) and against the JAX package's ``solve_batched`` at the solver
twins' tolerance (costs ``rtol=1e-4``; controls ``rtol=1e-3``, ``atol=1e-4``
times the largest, tests/test_torch_models.py)."""

import io
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx

import simplemath_tpu.utils as jutils
import simplemath_tpu_torch as sm
import simplemath_tpu_torch.utils as tutils
from simplemath_tpu.models import ilqr as jilqr
from simplemath_tpu.models import make_cartpole as jax_cartpole
from simplemath_tpu_torch.models import ILQRConfig, make_cartpole
from simplemath_tpu_torch.models.ilqr import solve_batched
from simplemath_tpu_torch.ops import elementwise, library, matmul, program, reduction
from simplemath_tpu_torch.utils import MetricsLogger, benchmark, checkpoint
from simplemath_tpu_torch.utils import export as smx

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _on_the_cpu():
    """The port's default device is the card; these tests ask for the CPU."""
    old = sm.config.device
    sm.configure(device="cpu")
    yield
    sm.configure(device=old)


def test_utils_export_every_public_name_of_the_jax_package():
    public = {n for n in dir(jutils) if not n.startswith("_")}
    public -= {"profiling", "metrics", "elastic", "precision"}  # submodules
    missing = sorted(n for n in public if not hasattr(tutils, n))
    assert not missing, missing
    for name in ("BenchResult", "annotate", "benchmark", "trace", "MetricsLogger", "checkpoint",
                 "export", "ElasticConfig", "RestartBudgetExceeded", "StateCorruption",
                 "resume_state", "run_elastic", "f32_matmuls"):
        assert hasattr(tutils, name), name


def test_benchmark_result():
    x = torch.ones((256, 256), dtype=torch.float32)
    res = benchmark(lambda a: a + 1.0, x, warmup=1, repeats=3, bytes_moved=2 * x.numel() * 4)
    assert res.median_s > 0 and res.best_s <= res.median_s and len(res.times_s) == 3
    assert res.gbps is not None and res.gbps > 0
    assert 0 < res.roofline_fraction
    assert res.tflops is None


def test_hbm_bandwidth_of_the_cpu_and_the_h100():
    from simplemath_tpu_torch.utils import profiling

    assert profiling.hbm_bandwidth_bytes_per_s("cpu") == 50e9
    assert profiling.HBM_BANDWIDTH["h100 80gb hbm3"] == 3.35e12
    assert not any("tpu" in k for k in profiling.HBM_BANDWIDTH)


def test_trace_writes_a_chrome_trace(tmp_path):
    from simplemath_tpu_torch.utils import annotate, trace

    a = sm.Array(np.arange(16, dtype=np.float32))
    with trace(str(tmp_path)) as prof:
        with annotate("sm_add"):
            (a + a).torch()
    names = {e.key for e in prof.key_averages()}
    assert "sm_add" in names
    assert os.path.getsize(tmp_path / "trace.json") > 0


def test_metrics_logger(tmp_path):
    log = MetricsLogger("test")
    log.log(0, cost=1.5, residual=torch.tensor(0.25))
    log.log(1, cost=1.0, residual=torch.tensor(0.125), vec=torch.tensor([1.0, 2.0]))
    assert len(log) == 2
    assert log.summary()["cost"] == 1.0
    assert log.summary()["residual"] == 0.125 and log.summary()["vec"] == [1.0, 2.0]
    path = os.path.join(tmp_path, "metrics.jsonl")
    log.dump_jsonl(path)
    with open(path) as f:
        lines = f.readlines()
    assert len(lines) == 2


def test_log_ilqr_result_matches_the_jax_logger():
    system = make_cartpole()
    x0s = 0.1 * torch.ones(3, system.nx)
    res = solve_batched(system, x0s, torch.zeros(3, 8, 1), ILQRConfig(iterations=2))
    mine, theirs = MetricsLogger("c"), jutils.MetricsLogger("c")
    mine.log_ilqr_result(0, res)
    theirs.log_ilqr_result(0, jilqr.ILQRResult(*(np.asarray(x) for x in res)))
    assert mine.summary() == theirs.summary()


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "us": torch.ones((10, 2), dtype=torch.float32),
        "step": torch.tensor(7),
        "nested": {"x": torch.arange(5)},
        "half": torch.full((3,), 1.5, dtype=torch.bfloat16),
    }
    path = os.path.join(tmp_path, "ckpt")
    checkpoint.save(path, state, metadata={"note": "test"})
    assert sorted(os.listdir(path)) == ["meta.json", "state.pt", "treedef.json"]
    restored = checkpoint.restore(path, like=state)
    np.testing.assert_array_equal(restored["us"].numpy(), np.ones((10, 2)))
    assert int(restored["step"]) == 7
    np.testing.assert_array_equal(restored["nested"]["x"].numpy(), np.arange(5))
    assert restored["half"].dtype == torch.bfloat16 and torch.equal(restored["half"], state["half"])


def test_checkpoint_structure_mismatch_raises(tmp_path):
    state = {"us": torch.ones((4,)), "step": torch.tensor(1)}
    path = os.path.join(tmp_path, "ckpt")
    checkpoint.save(path, state)
    wrong = {"us": torch.ones((4,)), "extra": torch.tensor(0)}
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(path, like=wrong)
    ok = checkpoint.restore(path, like=state)
    assert int(ok["step"]) == 1


def test_checkpoint_reads_the_jax_npz_backend(tmp_path, monkeypatch):
    """A checkpoint the JAX package wrote with its npz backend restores
    here, checked by leaf count and shape; an orbax one raises."""
    from simplemath_tpu.utils import checkpoint as jckpt

    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    state = {"us": jnp.arange(12, dtype=jnp.float32).reshape(6, 2), "step": jnp.asarray(3)}
    path = os.path.join(tmp_path, "jax")
    jckpt.save(path, state)
    like = {"us": torch.zeros(6, 2), "step": torch.tensor(0)}
    got = checkpoint.restore(path, like=like)
    np.testing.assert_array_equal(got["us"].numpy(), np.asarray(state["us"]))
    assert int(got["step"]) == 3
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(path, like={"us": torch.zeros(6, 3), "step": torch.tensor(0)})
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(path, like={"us": torch.zeros(6, 2)})
    with open(os.path.join(path, "meta.json"), "w") as f:
        f.write('{"backend": "orbax"}')
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.restore(path, like=like)


# ------------------------------------------------------------ the sm ops
def _ops_cases():
    """(name, function of seeded CPU tensors, its operands): one call of
    each kernel wrapper, each of the six ops."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((48, 40)).astype(np.float32))
    x3 = torch.from_numpy(rng.standard_normal((3, 64, 48)).astype(np.float32))
    w3 = torch.from_numpy(rng.standard_normal((3, 48, 40)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal((1, 40)).astype(np.float32))
    layer = sm.fuse(lambda x, w_, b_: sm.maximum(x @ w_ + b_, 0.0))
    axis0 = sm.fuse(lambda x: sm.sum(sm.where(x > 0.25, x, 0.0), axis=0))
    rec = sm.fuse(lambda acc, x, e: acc * 0.5 + sm.exp(x * e), donate=0, iterations=4)
    return [
        ("sm.ew_flat.default", lambda a, b: (sm.Array(a) * sm.Array(b) + 1.0).torch(), (a, b)),
        ("sm.ew_strided.default", lambda a, b, e: rec(sm.Array(a), sm.Array(b), sm.Array(e)).torch(),
         (a, b, b[:1].clone())),
        ("sm.rd_full.default", lambda a: sm.Array(a).sum().torch(), (a,)),
        ("sm.rd_axis.default", lambda a: axis0(sm.Array(a)).torch(), (a,)),
        ("sm.mm.default", lambda x, w_, b_: layer(sm.Array(x), sm.Array(w_), sm.Array(b_)).torch(),
         (a, w, bias)),
        ("sm.bmm.default", lambda x, w_, b_: layer(sm.Array(x), sm.Array(w_), sm.Array(b_)).torch(),
         (x3, w3, bias[None])),
    ]


_OPS = [c[0] for c in _ops_cases()]


@pytest.mark.parametrize("name", _OPS)
def test_each_sm_op_exports_and_round_trips(name):
    """An exported call holds its ``sm::*`` node and no plain-version op,
    and the loaded artifact's CPU implementation (the plain version) gives
    the live call's bits."""
    _, fn, args = next(c for c in _ops_cases() if c[0] == name)
    ep = smx.export_program(fn, *args)
    assert library.sm_nodes(ep.graph) == [name]
    aten = {str(n.target) for n in ep.graph.nodes if n.op == "call_function"}
    assert aten == {name}, aten
    run = smx.load_step(smx.export_step(fn, *args))
    assert torch.equal(run(*args), fn(*args))


@pytest.mark.parametrize("name", _OPS)
def test_each_sm_op_fake_matches_its_cpu_implementation(name):
    """Each op's fake implementation (a trace with fake tensors) gives the
    shape and dtype of its CPU implementation on the same call."""
    _, fn, args = next(c for c in _ops_cases() if c[0] == name)
    gm = make_fx(fn, tracing_mode="fake")(*args)
    (node,) = [n for n in gm.graph.nodes if str(n.target) == name]
    real = []

    class Record(torch.fx.Interpreter):
        def run_node(self, n):
            out = super().run_node(n)
            if n is node:
                real.append(out)
            return out

    Record(gm).run(*args)
    fake = node.meta["val"]
    assert fake.shape == real[0].shape and fake.dtype == real[0].dtype


def test_eager_calls_do_not_trace_and_trace_calls_go_through_the_ops():
    assert not library.tracing([torch.ones(2)])
    with FakeTensorMode():
        assert library.tracing([torch.ones(2)])


@pytest.mark.parametrize("seed", range(4))
def test_program_encoding_round_trips(seed):
    """``encode_program`` / ``decode_program`` over programs with every
    kind of constant, a cast and a select."""
    rng = np.random.default_rng(seed)
    la, lb = program.leaf((5,), torch.float32), program.leaf((5,), torch.int32)
    lu = program.leaf((5,), torch.uint32)
    c = float(rng.uniform(-3, 3))
    exprs = [
        program.lower(la * c + 1.5, [la]),
        program.lower(program.apply("where", la > 0.0, la, program.cast(lb, torch.float32)),
                      [la, lb]),
        program.lower(lb // -7 + int(rng.integers(-2**31, 2**31 - 1)), [lb]),
        program.lower(lu * program.const(np.uint32(2**32 - 3)), [lu]),
        program.lower(program.cast(la, torch.bfloat16) * 0.3, [la]),
    ]
    for prog in exprs:
        back = library.decode_program(library.encode_program(prog))
        assert back.leaf_dtypes == prog.leaf_dtypes and back.dtype == prog.dtype
        assert back.insts == prog.insts and back.result == prog.result
        assert [dt for _, dt in back.consts] == [dt for _, dt in prog.consts]
        assert back.kernel_codes == prog.kernel_codes
        ops = [torch.from_numpy(rng.standard_normal(5).astype(np.float32)),
               torch.from_numpy(rng.integers(-50, 50, 5).astype(np.int32)),
               torch.from_numpy(rng.integers(0, 50, 5).astype(np.int64)).to(torch.uint32)]
        ops = [next(o for o in ops if o.dtype == dt) for dt in prog.leaf_dtypes]
        assert torch.equal(program.run_plain(back, ops, (5,)), program.run_plain(prog, ops, (5,)))


def test_views_travel_as_op_arguments():
    """A negative-step view operand is described by offset, shape and
    strides, and the op reads the same elements."""
    base = torch.arange(24, dtype=torch.float32)
    view = elementwise.View(base, 23, (3, 4), (-4, -1))
    (back,) = library.views([base], library.encode_views([view]))
    assert back == view
    leaf = program.leaf((3, 4), torch.float32)
    prog = program.lower(leaf * 2.0, [leaf])
    got = library.call_elementwise(prog, (3, 4), [view], False, 1, 0)
    assert torch.equal(got, elementwise.read(view) * 2.0)
    assert torch.equal(reduction.run(prog, "sum", 1, (3, 4), [view]),
                       library.call_reduction(prog, 0, (3, 4), [view], 1))
    w = torch.ones(4, 2)
    assert torch.equal(matmul.matmul(view, w), library.call_matmul(view, w, torch.float32, None, []))


# --------------------------------------------------------------- export
class TestAOTExport:
    def test_plain_roundtrip(self, tmp_path):
        p = tmp_path / "step.pt2"
        smx.save_step(p, lambda x: torch.tanh(x) * 2, torch.ones((8,)))
        run = smx.load_step(str(p))
        out = run(torch.full((8,), 0.5)).numpy()
        np.testing.assert_allclose(out, np.tanh(0.5) * 2, rtol=1e-6)

    def test_pallas_kernel_roundtrip(self):
        """``a * b + 1`` through ``sm::ew_flat``'s CPU implementation; the
        graph holds the op."""

        def k(x, y):
            return elementwise.elementwise(
                _mul_add_one(), tuple(x.shape), torch.float32, x, y, name="exp_mul")

        ep = smx.export_program(k, torch.ones(256, 256), torch.ones(256, 256))
        assert library.sm_nodes(ep.graph) == ["sm.ew_flat.default"]
        run = smx.load_step(smx.export_step(k, torch.ones(256, 256), torch.ones(256, 256)))
        out = run(torch.full((256, 256), 2.0), torch.full((256, 256), 3.0)).numpy()
        np.testing.assert_allclose(out, 7.0)

    def test_shape_mismatch_raises(self):
        run = smx.load_step(smx.export_step(lambda x: x + 1, torch.ones((8,))))
        with pytest.raises(Exception):
            run(torch.ones((9,)))

    def test_a_branch_on_a_value_raises(self):
        """A branch on a tensor's value cannot be exported in either
        package: JAX raises on the tracer's conversion, the port at the
        host read, so no artifact fixes the example's branch."""

        def f(x):
            return x * 2 if x.sum() > 0 else x

        with pytest.raises(jax.errors.ConcretizationTypeError):
            jutils.export.export_step(f, jnp.ones((8,), jnp.float32))
        for read in (f, lambda x: x * x.sum().item(), lambda x: x + int(x[0])):
            with pytest.raises(smx.DataDependentError):
                smx.export_step(read, torch.ones((8,)))

    def test_platforms_other_than_cuda_or_cpu_raise(self):
        with pytest.raises(ValueError, match="platforms"):
            smx.export_step(lambda x: x + 1, torch.ones(2), platforms=("tpu",))
        with pytest.raises(ValueError, match="example argument"):
            smx.export_step(lambda x: x + 1, torch.ones(2), platforms=("cuda",))
        assert smx.load_step(smx.export_step(lambda x: x + 1, torch.ones(2),
                                             platforms=("cpu",)))(torch.ones(2))[0] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_constant_bits_are_torchs_rounding(dtype):
    """A program constant's register bits, computed without a tensor (so
    that a trace reads no value), are those of the constant converted by
    torch and widened to float32 (a NaN's payload aside)."""
    rng = np.random.default_rng(7)
    values = [0.0, -0.0, 1.0, -2.5, 1e-3, 1e-45, 1e-8, 65504.0, 65520.0, 3.4e38, 3.5e38, 1e300,
              -1e300, float("inf"), float("-inf"), float("nan"), 1.0 + 2.0 ** -8, 1.0 + 2.0 ** -9,
              1.0 + 3 * 2.0 ** -9, *rng.standard_normal(200) * 10.0 ** rng.integers(-30, 30, 200)]
    for v in values:
        want = int(torch.tensor(v, dtype=dtype).to(torch.float32).view(torch.int32)) & 0xFFFFFFFF
        got = elementwise._const_bits(v, dtype)
        nan = [np.isnan(np.uint32(b).view(np.float32)) for b in (got, want)]
        assert got == want or nan == [True, True], (v, dtype)


def _mul_add_one():
    la, lb = program.leaf((256, 256), torch.float32), program.leaf((256, 256), torch.float32)
    return program.lower(la * lb + np.float32(1.0), [la, lb])


@pytest.fixture(scope="module")
def solver_artifact(tmp_path_factory):
    """The cartpole solve step exported at batch 4, H=10, 2 iterations, on
    the CPU: its bytes, a file of them and the loaded step."""
    old = sm.config.device
    sm.configure(device="cpu")
    try:
        blob = smx.export_solver_step(make_cartpole(), ILQRConfig(iterations=2), batch=4,
                                      horizon=10)
    finally:
        sm.configure(device=old)
    path = tmp_path_factory.mktemp("artifact") / "cartpole.pt2"
    path.write_bytes(blob)
    return blob, str(path), smx.load_step(str(path))


def _served_inputs():
    x0s = (0.1 * np.ones((4, 4))).astype(np.float32)
    x0s[1:] += (0.2 * np.random.default_rng(5).standard_normal((3, 4))).astype(np.float32)
    return x0s, np.zeros((4, 10, 1), np.float32)


def test_solver_step_roundtrip(solver_artifact):
    """The served step equals the port's live solve (the JAX test's
    tolerance; here the bits are the same)."""
    *_, run = solver_artifact
    x0s, us0 = (torch.from_numpy(a) for a in _served_inputs())
    us, cost = run(x0s, us0)
    ref = solve_batched(make_cartpole(), x0s, us0, ILQRConfig(iterations=2))
    np.testing.assert_allclose(cost.numpy(), ref.cost.numpy(), rtol=1e-6)
    np.testing.assert_allclose(us.numpy(), ref.us.numpy(), rtol=1e-6, atol=1e-7)
    assert torch.equal(us, ref.us) and torch.equal(cost, ref.cost)


def test_solver_step_against_the_jax_package(solver_artifact):
    """The served step against the JAX package's ``solve_batched`` on the
    same inputs, at the solver twins' tolerance."""
    *_, run = solver_artifact
    x0s, us0 = _served_inputs()
    us, cost = run(torch.from_numpy(x0s), torch.from_numpy(us0))
    rj = jax.jit(lambda x, u: jilqr.solve_batched(jax_cartpole(), x, u,
                                                  jilqr.ILQRConfig(iterations=2)))(
        jnp.asarray(x0s), jnp.asarray(us0))
    np.testing.assert_allclose(cost.numpy(), np.asarray(rj.cost), rtol=1e-4)
    np.testing.assert_allclose(us.numpy(), np.asarray(rj.us), rtol=1e-3,
                               atol=1e-4 * max(1.0, float(np.abs(np.asarray(rj.us)).max())))


def test_a_served_artifact_needs_only_the_package(solver_artifact, tmp_path):
    """A process that imports ``simplemath_tpu_torch`` and torch alone (no
    model code, no jax) loads and serves the artifact."""
    _, path, _ = solver_artifact
    x0s, us0 = _served_inputs()
    np.save(tmp_path / "x0s.npy", x0s)
    np.save(tmp_path / "us0.npy", us0)
    script = (
        "import sys, numpy as np, torch, simplemath_tpu_torch\n"
        "from simplemath_tpu_torch.utils import export\n"
        f"run = export.load_step({path!r})\n"
        f"us, cost = run(torch.from_numpy(np.load({str(tmp_path / 'x0s.npy')!r})),"
        f" torch.from_numpy(np.load({str(tmp_path / 'us0.npy')!r})))\n"
        f"np.save({str(tmp_path / 'cost.npy')!r}, cost.numpy())\n"
        "assert 'jax' not in sys.modules and 'simplemath_tpu' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, SM_DEVICE="cpu")
    subprocess.run([sys.executable, "-c", script], check=True, env=env, timeout=600)
    ref = solve_batched(make_cartpole(), torch.from_numpy(x0s), torch.from_numpy(us0),
                        ILQRConfig(iterations=2))
    np.testing.assert_array_equal(np.load(tmp_path / "cost.npy"), ref.cost.numpy())


def test_export_save_and_load_use_bytes_and_files(tmp_path):
    blob = smx.export_step(lambda x: x * 3, torch.ones(4096))
    assert isinstance(blob, bytes)
    assert torch.export.load(io.BytesIO(blob)).example_inputs is None  # not 16 KB of them
    blob = smx.export_step(lambda x: x * 3, torch.ones(4))
    buf = io.BytesIO(blob)
    assert torch.equal(torch.export.load(buf).module()(torch.ones(4)), torch.full((4,), 3.0))
