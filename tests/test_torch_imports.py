"""Rules of the port: ``repro_torch`` and ``chip_smoke.py`` import nothing of
JAX or of the JAX package; entry points refuse to run quietly on the CPU;
a CUDA-kernel wrapper refuses CPU tensors under ``KernelMode.CUDA``."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    yield from _roots_of(path.read_text(), str(path))


def _roots_of(source, filename="<string>"):
    """Top-level packages a source imports: ``import`` statements, and the
    string (or f-string head) given to ``import_module``/``__import__``."""
    tree = ast.parse(source, filename=filename)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", None)
            if name not in ("import_module", "__import__"):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr) and arg.values:
                arg = arg.values[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_static_check_sees_dynamic_imports():
    roots = set(_roots_of(
        'import importlib\n'
        'importlib.import_module(f"repro.configs.{arch}")\n'
        '__import__("jax.numpy")\n'))
    assert {"repro", "jax"} <= roots


_BLOCK_JAX = (
    "import sys\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "sys.meta_path.insert(0, Block())\n")


def _run_blocked(code):
    out = subprocess.run([sys.executable, "-c", _BLOCK_JAX + code],
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_get_config_returns_the_ports_config_with_jax_blocked():
    code = (
        "from repro_torch.configs import ARCH_IDS, get_config\n"
        "from repro_torch.models.config import ModelConfig\n"
        "for arch in ARCH_IDS:\n"
        "    for smoke in (False, True):\n"
        "        cfg = get_config(arch, smoke=smoke)\n"
        "        assert type(cfg) is ModelConfig, (arch, type(cfg))\n"
        "print(len(ARCH_IDS))\n")
    assert _run_blocked(code) == "10"


def test_port_imports_with_jax_blocked():
    code = (
        "import pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n")
    assert _run_blocked(code) == "ok"


RECURRENT_MODULES = ["kernels/ssd/kernel.py", "kernels/ssd/ops.py",
                     "kernels/ssd/ref.py", "kernels/rglru/kernel.py",
                     "kernels/rglru/ops.py", "kernels/rglru/ref.py",
                     "models/ssm.py", "models/rglru.py"]


def test_static_check_covers_the_recurrent_modules():
    port = ROOT / "src" / "repro_torch"
    assert {port / m for m in RECURRENT_MODULES} <= set(PORT_FILES)


def test_recurrent_families_run_with_jax_blocked():
    """The SSM and hybrid families import, build and run their full-sequence
    and decode paths on the CPU with JAX and the JAX package blocked."""
    code = (
        "import torch\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.models.lm import build_model\n"
        "for arch in ('mamba2_780m', 'recurrentgemma_9b'):\n"
        "    m = build_model(get_config(arch, smoke=True), device='cpu')\n"
        "    p = m.init(torch.Generator().manual_seed(0))\n"
        "    tok = torch.zeros((1, 16), dtype=torch.int32)\n"
        "    assert m.prefill(p, {'tokens': tok}).shape[0] == 1\n"
        "    st = m.init_decode_state(1, 8)\n"
        "    m.decode_step(p, st, {'tokens': tok[:, :1]})\n"
        "print('ok')\n")
    assert _run_blocked(code) == "ok"


CONTROL_MODULES = ["stats.py", "telemetry.py", "serve/__init__.py",
                   "serve/harness.py", "shell/server.py", "fabric/fabric.py",
                   "manager/__init__.py", "manager/telemetry.py",
                   "manager/trackers.py", "manager/forecast.py",
                   "manager/policies.py", "manager/slo.py",
                   "manager/manager.py", "manager/adversary.py",
                   "manager/scenarios.py"]


def test_static_check_covers_the_control_plane_modules():
    port = ROOT / "src" / "repro_torch"
    assert {port / m for m in CONTROL_MODULES} <= set(PORT_FILES)


def test_control_plane_runs_with_jax_blocked():
    """The manager, its scenarios (on a ``ServerPool`` and under attack),
    the serve harness and the fabric's probe import and run on the CPU
    with JAX and the JAX package blocked."""
    code = (
        "import repro_torch.telemetry, repro_torch.stats\n"
        "from repro_torch.manager import run_scenario, adversarial_policy\n"
        "from repro_torch.serve import (ServeHarness, SeededEngine,\n"
        "                               front_loaded_arrivals)\n"
        "from repro_torch.core.elastic import Region\n"
        "from repro_torch.core.module import ModuleFootprint\n"
        "from repro_torch.shell import Shell\n"
        "from repro_torch.shell.server import ElasticServer\n"
        "r = run_scenario('adversarial', ticks=8, device='cpu',\n"
        "                 fabric_backend='cuda', policy=adversarial_policy())\n"
        "p = run_scenario('production', ticks=8, n_regions=8, n_servers=2,\n"
        "                 device='cpu')\n"
        "shell = Shell([Region(rid=i, n_chips=8, hbm_bytes=1 << 33)\n"
        "               for i in range(2)])\n"
        "shell.submit('svc', [ModuleFootprint(1 << 30, 1e9, 4096)], app_id=0)\n"
        "srv = ElasticServer(shell, n_slots=4, device='cpu')\n"
        "srv.register_engine(0, SeededEngine())\n"
        "rep = ServeHarness(srv, front_loaded_arrivals(8, max_new=3)).run()\n"
        "assert srv.fabric.probe().sample()['fabric_traces'] == 1\n"
        "print(r.fabric_retraces, p.n_servers, rep.completions)\n")
    assert _run_blocked(code) == "1 2 8"


TRAINING_MODULES = ["core/registers.py", "core/__init__.py",
                    "fabric/sanitize.py", "fabric/fabric.py",
                    "models/moe.py", "models/lm.py", "optim/compress.py",
                    "optim/__init__.py", "data/pipeline.py",
                    "ckpt/checkpoint.py", "runtime/ft.py",
                    "runtime/train.py", "runtime/__init__.py"]


def test_static_check_covers_the_training_runtime_modules():
    port = ROOT / "src" / "repro_torch"
    assert {port / m for m in TRAINING_MODULES} <= set(PORT_FILES)


def test_training_runtime_runs_with_jax_blocked(tmp_path):
    """The training runtime, its checkpoints, the sanitizer and the MoE's
    dense impl import and run on the CPU with JAX, the JAX package and
    ``ml_dtypes`` blocked: a published MoE config builds as it is and a
    ``TrainLoop`` crashes after a checkpoint and resumes from it."""
    code = (
        "import torch\n"
        "sys.modules['ml_dtypes'] = None        # import ml_dtypes raises\n"
        "from repro_torch.configs import get_config\n"
        "from repro_torch.core import validate_registers\n"
        "from repro_torch.core.registers import CrossbarRegisters\n"
        "from repro_torch.fabric import Fabric, FabricCheckError\n"
        "from repro_torch.models.lm import DenseLM\n"
        "from repro_torch.optim import compress_int8\n"
        "from repro_torch.runtime import TrainLoop, TrainLoopConfig\n"
        "DenseLM(get_config('mixtral_8x7b', smoke=True), device='cpu')\n"
        "regs = CrossbarRegisters.create(2, capacity=1)\n"
        "validate_registers(regs)\n"
        "try:\n"
        "    Fabric(regs, debug='strict', device='cpu').plan(\n"
        "        torch.zeros(3, dtype=torch.int32),\n"
        "        torch.zeros(3, dtype=torch.int32))\n"
        "    raise SystemExit('no raise')\n"
        "except FabricCheckError:\n"
        "    pass\n"
        "compress_int8(torch.ones(3))\n"
        "cfg = get_config('mixtral_8x7b', smoke=True)\n"
        "run = TrainLoopConfig(steps=3, global_batch=1, seq_len=16,\n"
        "                      ckpt_every=1, log_every=1)\n"
        f"root = {str(tmp_path)!r}\n"
        "TrainLoop(cfg, run, ckpt_dir=root, device='cpu').run_loop()\n"
        "loop = TrainLoop(cfg, run, ckpt_dir=root, resume=True, device='cpu')\n"
        "assert sys.modules['ml_dtypes'] is None\n"
        "print(loop.start_step)\n")
    assert _run_blocked(code) == "3"


def test_control_plane_entry_points_without_device_raise_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core.elastic import Region
    from repro_torch.manager import run_scenario
    from repro_torch.shell import Shell
    from repro_torch.shell.server import ElasticServer, ServerPool
    shell = Shell([Region(rid=0, n_chips=1, hbm_bytes=1 << 30)])
    with pytest.raises(RuntimeError, match="CUDA"):
        ServerPool(shell, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ElasticServer(shell, slots_per_region=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario("bursty", ticks=2)
    assert ServerPool(shell, 2, device="cpu").device.type == "cpu"


def test_entry_points_without_device_raise_when_cuda_is_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.configs import get_config
    from repro_torch.core.elastic import Region
    from repro_torch.core.registers import CrossbarRegisters
    from repro_torch.fabric import Fabric
    from repro_torch.shell import Shell
    from repro_torch.shell.server import ElasticServer, ModelEngine
    from repro_torch.ckpt.convert import (opt_state_from_numpy,
                                          params_from_numpy)
    from repro_torch.models.attention import init_cache
    from repro_torch.models.lm import DenseLM, build_model
    regs = CrossbarRegisters.create(4)
    cfg = get_config("tinyllama_1_1b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        Fabric(regs)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        DenseLM(cfg)
    for arch in ("mamba2_780m", "recurrentgemma_9b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_model(get_config(arch, smoke=True))
        with pytest.raises(RuntimeError, match="CUDA"):
            ModelEngine(get_config(arch, smoke=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"layers": {}}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        opt_state_from_numpy(0, {"layers": {}}, {"layers": {}}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cache(1, 1, 8, 1, 16)
    from repro_torch.runtime import TrainLoop, TrainLoopConfig
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainLoop(cfg, TrainLoopConfig(steps=1))
    shell = Shell([Region(rid=0, n_chips=1, hbm_bytes=1 << 30)])
    with pytest.raises(RuntimeError, match="CUDA"):
        shell.fabric()
    with pytest.raises(RuntimeError, match="CUDA"):
        ElasticServer(shell)
    Fabric(regs, device="cpu")                    # asked for: fine
    assert build_model(cfg, device="cpu").device.type == "cpu"


def test_cuda_mode_with_cpu_tensors_raises():
    from repro_torch.fabric import Fabric, KernelMode
    from repro_torch.core.registers import CrossbarRegisters
    from repro_torch.kernels.crossbar_dispatch import kernel as K
    dst = torch.zeros(4, dtype=torch.int32)
    a = torch.ones((2, 2), dtype=torch.int32)
    before = K.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        K.plan_multi(dst, dst, a, a, mode=KernelMode.CUDA)
    with pytest.raises(ValueError, match="CUDA"):
        K.scatter(torch.ones(4, 8), dst, dst, dst, n_ports=2, capacity=4,
                  mode="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        K.combine(torch.ones(2, 4, 8), dst, dst, dst, torch.ones(4),
                  mode=KernelMode.CUDA)
    with pytest.raises(ValueError, match="CUDA"):
        Fabric(CrossbarRegisters.create(2), backend="cuda_kernel",
               device="cpu", kernel_mode="cuda")
    assert K.launch_counts() == before            # refusals launch nothing


@pytest.mark.parametrize("alias,mode", [
    ("xla", "TORCH"), ("reference", "TORCH"), ("ref", "TORCH"),
    ("pallas_interpret", "TORCH"), ("interpret", "TORCH"),
    ("pallas", "CUDA"), ("mosaic", "CUDA"), ("auto", "AUTO")])
def test_kernel_mode_aliases(alias, mode):
    from repro_torch.fabric.interface import (KernelMode, parse_kernel_mode,
                                              resolve_kernel_mode)
    assert parse_kernel_mode(alias) is KernelMode[mode]
    if mode != "CUDA":
        assert resolve_kernel_mode(alias, "cpu") is KernelMode.TORCH
    assert resolve_kernel_mode(alias, "cuda") is (
        KernelMode.TORCH if mode == "TORCH" else KernelMode.CUDA)
