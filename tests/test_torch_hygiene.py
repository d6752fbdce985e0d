"""The port stands alone: no file of ``src/repro_torch`` (nor the port's
examples, ``examples/*_torch.py``, nor ``chip_smoke.py``) imports JAX or
the JAX package, importing the serving and training entry points pulls
no JAX in, and entry points (serving, the router, the HTTP server, the
load test, training, the pipeline's dry run, the examples, the CI
regression gate) refuse to run on the CPU unless asked to."""
import pytest
from _torch_threads import cap_torch_threads

torch = pytest.importorskip("torch")
cap_torch_threads(torch)

import ast  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + EXAMPLES + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_serve_import_pulls_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert, "
            "repro_torch.kernels.build, repro_torch.launch.server, "
            "repro_torch.launch.loadtest; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("modules", [
    "repro_torch.launch.train, repro_torch.launch.steps",
    "repro_torch.optim.adamw, repro_torch.optim.compression",
    "repro_torch.data.synthetic, repro_torch.data.pipeline",
    "repro_torch.checkpoint.checkpointer, repro_torch.tree",
    "repro_torch.parallel, repro_torch.launch.mesh, "
    "repro_torch.launch.sharding",
    "repro_torch.runtime.elastic, repro_torch.launch.pipeline, "
    "repro_torch.core.quant, repro_torch.core.qweights"])
def test_train_import_pulls_no_jax(modules):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (f"import sys, {modules}; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_train_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch,
                                                          tmp_path):
    """``TrainLoop``, ``make_train_step`` / ``make_eval_step`` and the
    train CLI refuse to run without CUDA unless the CPU is asked for."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import steps, train
    from repro_torch.optim.adamw import AdamW

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("olmo-1b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        train.TrainLoop(cfg, steps=1, batch=2, seq=8)
    for make in (lambda: steps.make_train_step(cfg, AdamW()),
                 lambda: steps.make_eval_step(cfg)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    argv = ["--reduced", "--steps", "2", "--batch", "2", "--seq", "8"]
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(argv)
    loop = train.main(argv + ["--device", "cpu", "--ckpt",
                              str(tmp_path)])
    assert [h["step"] for h in loop.history] == [0, 1]


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_jax
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("qwen3-0.6b").reduced()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": [1.0]})
    params = lm.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_batch(cfg, params, [[1, 2, 3, 4, 5, 6, 7, 8]], 2)
    toks, _ = serve_batch(cfg, params, [[1, 2, 3, 4, 5, 6, 7, 8]], 2,
                          device="cpu")
    assert toks.shape == (1, 2)


def test_continuous_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    """``serve_continuous`` and the CLI's ``--continuous`` refuse to run
    without CUDA, as ``serve_batch`` does, unless the CPU is asked for."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import main, serve_continuous
    from repro_torch.models import lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("qwen3-0.6b").reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8]] * 2
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_continuous(cfg, params, prompts, 2, slots=2)
    outs, stats = serve_continuous(cfg, params, prompts, 2, slots=2,
                                   device="cpu")
    assert [len(o) for o in outs] == [2, 2] and stats["requests"] == 2
    argv = ["--reduced", "--continuous", "--requests", "2", "--batch", "2",
            "--prompt-len", "4", "--tokens", "2"]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    assert main(argv + ["--device", "cpu"]) == 0


def test_router_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    """The router, the HTTP server's ``main`` and the load test's refuse
    to run without CUDA unless the CPU is asked for."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import loadtest, server
    from repro_torch.models import lm
    from repro_torch.runtime.router import Router

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_arch("qwen3-0.6b").reduced()
    params = lm.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Router(cfg, params)
    assert Router(cfg, params, device="cpu").stats()["submitted"] == 0
    for main, argv in ((server.main, ["--reduced"]),
                       (loadtest.main, ["--smoke", "--reduced"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    assert loadtest.main(["--smoke", "--reduced", "--requests", "6",
                          "--device", "cpu"]) == 0


def test_bench_regression_needs_cuda_unless_cpu_is_asked(monkeypatch):
    """The CI regression gate refuses to run without CUDA unless the CPU
    is asked for, before any leg runs."""
    from repro_torch.launch import bench_regression

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(bench_regression, "measure",
                        lambda *a, **k: ran.append(a))
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_regression.main(["--smoke"])
    assert not ran


def test_examples_and_dryrun_need_cuda_unless_cpu_is_asked(monkeypatch):
    """The two examples and ``pp_dryrun`` refuse to run without CUDA
    unless the CPU is asked for."""
    import importlib.util
    from repro_torch.launch.pipeline import pp_dryrun

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for path in EXAMPLES:
        if path.name == "train_lm_torch.py":
            continue
        spec = importlib.util.spec_from_file_location(path.stem, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main([])

    class Pod2:
        sizes = {"pod": 2, "data": 1, "model": 1}
    with pytest.raises(RuntimeError, match="CUDA"):
        pp_dryrun(par=Pod2())


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper takes the plain version only for CPU tensors; anything
    else that is not CUDA raises instead of falling back."""
    from repro_torch.core.seed_search import calibrated_config
    from repro_torch.core.qweights import prepare_linear_weight
    from repro_torch.kernels import (dscim_fused, dscim_mvm,
                                     dscim_mvm_blocked, flash_attention,
                                     int8_matmul, ops, paged_attention)

    cfg = calibrated_config("dscim1", 256)
    x = torch.zeros((1, 8), device="meta")
    qw = prepare_linear_weight(torch.ones((8, 4)), 8)
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        dscim_fused.dscim_fused_mvm_prepared(x, qw, cfg)
    q = torch.zeros((1, 1, 1, 8), device="meta")
    with pytest.raises(ValueError, match="route"):
        paged_attention.paged_attention_decode(q, *([None] * 8))
    xi = torch.zeros((2, 8), dtype=torch.int8, device="meta")
    wi = torch.zeros((8, 3), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="route"):
        dscim_mvm.dscim_counts(xi, wi, *ops.fold_constants(cfg), k=cfg.k,
                               length=cfg.length)
    with pytest.raises(ValueError, match="route"):
        dscim_mvm_blocked.dscim_counts_blocked(xi, wi, cfg)
    with pytest.raises(ValueError, match="route"):
        int8_matmul.int8_matmul(xi, wi)
    qa = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="route"):
        flash_attention.flash_attention(qa, qa, qa)


@pytest.mark.parametrize("path", PORT_FILES[:-1],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_calls_no_library_kernel(path):
    """The port computes with its own kernels: no module calls
    ``torch._int_mm``, ``scaled_dot_product_attention`` or
    ``torch.compile`` (``chip_smoke.py`` times the first two only as
    yardsticks)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    assert not names & {"_int_mm", "scaled_dot_product_attention",
                        "compile"}, path


CSRC_FILES = sorted((ROOT / "src" / "repro_torch" / "kernels" / "csrc").glob(
    "*.cu*"))


@pytest.mark.parametrize("path", CSRC_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_kernel_sources_are_written_by_hand(path):
    """No CUDA source includes or calls a library's finished kernels:
    cuBLAS, cuDNN, or CUTLASS's device-level GEMMs (CuTe/CUTLASS building
    blocks inside a kernel of the repository would be allowed)."""
    text = path.read_text().lower()
    for bad in ("cublas", "cudnn", "cutlass/gemm/device",
                "cutlass/gemm/kernel/default_gemm"):
        assert bad not in text, f"{path.name}: {bad}"


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    """Without CUDA, and alone in a directory without the package, the
    smoke script exits non-zero and prints no result line."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
