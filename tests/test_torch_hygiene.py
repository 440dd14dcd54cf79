"""PyTorch port, hygiene: the port imports nothing of JAX, of the JAX
package or of ``prometheus_client`` (the card's machine has none: the
port's metrics are plain Python), its modules import without nvcc, Triton
or a card, the host daemon's kubelet API files are the JAX package's byte
for byte and PyYAML is reached only for YAML specs, its entry
points refuse to fall back to the CPU on their own, and ``chip_smoke.py``
fails without a card or outside a checkout."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kata_xpu_device_plugin_tpu_torch import resolve_device
from kata_xpu_device_plugin_tpu_torch.guest import GenerationServer
from kata_xpu_device_plugin_tpu_torch.models import generate, init_params
from kata_xpu_device_plugin_tpu_torch.models.transformer import tiny_test_config
from kata_xpu_device_plugin_tpu_torch.ops import _build
from kata_xpu_device_plugin_tpu_torch.parallel import (
    TokenBatchLoader,
    fit,
    make_train_step,
)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "kata_xpu_device_plugin_tpu_torch"
JAX_PKG = "kata_xpu_device_plugin_tpu"


def _forbidden(name: str) -> bool:
    return any(name == m or name.startswith(m + ".")
               for m in ("jax", JAX_PKG, "prometheus_client"))


def _sources():
    # The process-mesh worker and the card's process-mesh tests run where
    # the port runs: no JAX there either.
    return (sorted(PORT.rglob("*.py")) + sorted((REPO / "scripts").glob("torch_*.py"))
            + [REPO / "chip_smoke.py", REPO / "tests" / "torch_procmesh_worker.py",
               REPO / "tests" / "test_torch_procmesh_cuda.py"])


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_port_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def _run(code, env_extra=None, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def test_package_imports_without_jax_nvcc_or_triton():
    mods = sorted(
        "kata_xpu_device_plugin_tpu_torch." + ".".join(
            p.relative_to(PORT).with_suffix("").parts).replace(".__init__", "")
        for p in PORT.rglob("*.py"))
    code = "\n".join([
        "import sys",
        *[f"import {m}" for m in mods],
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        f" or m == '{JAX_PKG}' or m.startswith('{JAX_PKG}.')"
        " or m.split('.')[0] == 'prometheus_client']",
        "assert not bad, bad",
        "assert 'triton' not in sys.modules",
        "print('ok')",
    ])
    res = _run(code, {"PATH": "/usr/bin:/bin"})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    real_exists = os.path.exists
    monkeypatch.setattr(_build.os.path, "exists",
                        lambda p: "nvcc" not in str(p) and real_exists(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("flash_fwd")
    assert _build.sources() == ["dense_decode", "flash_bwd", "flash_fwd",
                                "paged_decode"]


def test_build_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """A kernel's library name changes when a header it includes changes, so
    a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    (csrc / "shared.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build._target("k")
    (csrc / "shared.cuh").write_text("// v2\n")
    assert _build._target("k") != before
    assert (PORT / "csrc" / "decode_split.cuh").exists()


def test_every_cuda_source_is_named_in_chip_smoke():
    """Each ``csrc/*.cu`` is the ``source`` of a kernel in ``chip_smoke.py``'s
    kernels line (read as text: the script needs a card to run)."""
    text = (REPO / "chip_smoke.py").read_text()
    for src in sorted((PORT / "csrc").glob("*.cu")):
        assert f'source=f"{{src}}/{src.name}"' in text, src.name


def test_new_port_modules_are_under_the_import_guard():
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if p.is_relative_to(PORT)}
    assert {"guest/kv_arena.py", "guest/serving.py", "ops/decode_attn.py",
            "parallel/spmd.py", "parallel/flash_spmd.py", "parallel/pipeline.py",
            "parallel/composed.py", "models/convert.py", "guest/probe.py",
            "guest/distributed.py"} <= names
    assert set(DAEMON_MODULES) <= names
    assert REPO / "scripts" / "torch_serve_mesh_phase.py" in _sources()
    assert {"multihost/__init__.py", "multihost/resolver.py",
            "utils/podresources.py"} <= names
    for script in ("torch_eval_quality.py", "torch_multihost_phase.py"):
        assert REPO / "scripts" / script in _sources()


# The host daemon's modules (the GPU device plugin).
DAEMON_MODULES = (
    "__main__.py", "config.py", "cdi/__init__.py", "cdi/constants.py",
    "cdi/model.py", "cdi/names.py", "cdi/writer.py", "discovery/__init__.py",
    "discovery/gpu.py", "discovery/pciids.py", "discovery/sysfs.py",
    "discovery/vfio.py", "topology/__init__.py", "topology/host.py",
    "topology/preferred.py", "plugin/__init__.py", "plugin/allocators.py",
    "plugin/health.py", "plugin/manager.py", "plugin/server.py",
    "plugin/api/__init__.py", "plugin/api/glue.py",
    "plugin/api/deviceplugin_pb2.py", "plugin/api/podresources_pb2.py",
    "utils/__init__.py", "utils/inotify.py", "utils/log.py", "utils/metrics.py",
    "utils/podresources.py", "multihost/__init__.py", "multihost/resolver.py",
)


def test_plugin_api_copies_are_byte_identical():
    """The kubelet API files are the JAX package's, byte for byte: a proto
    edited under the same file name would clash in protobuf's default
    descriptor pool the moment one process loads both packages."""
    jax_api = REPO / JAX_PKG / "plugin" / "api"
    names = sorted(p.name for p in jax_api.iterdir() if p.is_file())
    assert names == ["__init__.py", "deviceplugin.proto", "deviceplugin_pb2.py",
                     "glue.py", "podresources.proto", "podresources_pb2.py"]
    for name in names:
        assert (PORT / "plugin" / "api" / name).read_bytes() == (
            jax_api / name).read_bytes(), name


def test_daemon_reaches_yaml_only_for_yaml_specs():
    """No daemon module imports ``yaml`` at import time: with PyYAML
    blocked the daemon imports, writes and reads a JSON spec, and only a
    YAML render raises."""
    for rel in DAEMON_MODULES:
        tree = ast.parse((PORT / rel).read_text(), rel)
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""])
                assert "yaml" not in names, f"{rel}:{node.lineno}"
    code = "\n".join([
        "import sys, tempfile",
        "sys.modules['yaml'] = None",
        "from kata_xpu_device_plugin_tpu_torch import cdi",
        "from kata_xpu_device_plugin_tpu_torch.plugin import PluginManager",
        "spec = cdi.Spec(kind='nvidia.com/gpu')",
        "spec.add_device(cdi.Device(name='0'))",
        "path = cdi.save(spec, tempfile.mkdtemp(), cdi.FORMAT_JSON)",
        "assert cdi.load(path).device_names() == ['0']",
        "try:",
        "    cdi.render(spec, cdi.FORMAT_YAML)",
        "except ImportError:",
        "    print('ok')",
    ])
    res = _run(code)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_convert_imports_safetensors_only_in_its_file_functions():
    """No module of the port imports ``safetensors`` or ``transformers`` at
    import time; ``models/convert.py`` reaches ``safetensors`` only from
    ``load_hf_checkpoint`` and ``save_hf_checkpoint``. With both packages
    blocked the module imports, converts in memory, and a file function
    raises an ``ImportError`` that names the package."""
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""])
                assert not any(n.split(".")[0] in ("safetensors", "transformers")
                               for n in names), f"{path}:{node.lineno}"
    tree = ast.parse((PORT / "models" / "convert.py").read_text())
    callers = {f.name for f in ast.walk(tree) if isinstance(f, ast.FunctionDef)
               and any(isinstance(c, ast.Call) and getattr(c.func, "id", "")
                       == "_safetensors" for c in ast.walk(f))}
    assert callers == {"load_hf_checkpoint", "save_hf_checkpoint"}
    code = "\n".join([
        "import sys",
        "sys.modules['safetensors'] = None",
        "sys.modules['transformers'] = None",
        "import torch",
        "from kata_xpu_device_plugin_tpu_torch.models import convert, init_params",
        "from kata_xpu_device_plugin_tpu_torch.models.transformer import tiny_test_config",
        "cfg = tiny_test_config(dtype=torch.float32, activation='swiglu',"
        " scale_embeddings=False, tie_embeddings=False)",
        "p = init_params(cfg, device='cpu')",
        "sd, hf = convert.to_hf_state_dict(p, cfg, 'llama')",
        "q, c = convert.from_hf(sd, hf, device='cpu')",
        "assert torch.equal(q['layers']['wq'], p['layers']['wq'])",
        "try:",
        "    convert.load_hf_checkpoint('.', device='cpu')",
        "except ImportError as e:",
        "    assert 'safetensors' in str(e), e",
        "    print('ok')",
    ])
    res = _run(code)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_entry_points_raise_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_test_config(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationServer(params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationServer(params, cfg, kv_pool_tokens=1024, kv_block_size=16)
    assert GenerationServer(params, cfg, kv_pool_tokens=1024, kv_block_size=16,
                            device="cpu").paged
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(params, [[1, 2, 3]], cfg, 2)
    assert generate(params, [[1, 2, 3]], cfg, 2, device="cpu").shape == (1, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_step(cfg)
    loader = TokenBatchLoader(list(range(64)), batch=2, seq_len=15)
    _, losses = fit(*make_train_step(cfg, device="cpu"), loader, steps=1)
    assert len(losses) == 1


def test_server_refuses_params_on_another_device():
    cfg = tiny_test_config(dtype=torch.float32)
    params = init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="params live on"):
        GenerationServer(params, cfg, device="meta")


def test_chip_smoke_fails_without_a_card():
    res = _run("import runpy, sys; sys.argv = ['chip_smoke.py']; "
               "runpy.run_path('chip_smoke.py', run_name='__main__')",
               {"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=240,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
