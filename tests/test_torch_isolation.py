"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, no source under ``src/repro_torch`` (nor ``chip_smoke.py``)
imports them, and its entry points run on CUDA unless asked for the CPU —
without a card they raise instead of carrying on on the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n.startswith("jaxlib.") or n == "repro" or n.startswith("repro."))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 20 else 0)
"""


def test_importing_every_module_loads_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b"
                        r"|from\s+jaxlib\b|import\s+repro(\.|\s|$)"
                        r"|from\s+repro(\.|\s))", re.M)


def test_no_source_imports_jax_or_the_jax_package():
    sources = sorted((SRC / "repro_torch").rglob("*.py"))
    assert len(sources) >= 20
    names = {p.relative_to(SRC).as_posix() for p in sources}
    assert {"repro_torch/core/extract.py", "repro_torch/kernels/rmsnorm.py",
            "repro_torch/launch/loop_extraction.py",
            "repro_torch/core/executor.py", "repro_torch/core/faults.py",
            "repro_torch/core/cost_model.py", "repro_torch/serving/replan.py",
            "repro_torch/launch/strategies.py",
            "repro_torch/launch/replanning.py"} <= names
    sources.append(SRC.parent / "chip_smoke.py")       # the card's smoke test
    offenders = [f"{p.relative_to(SRC.parent)}: {m.group(0).strip()}"
                 for p in sources for m in _FORBIDDEN.finditer(p.read_text())]
    assert offenders == []
    assert _FORBIDDEN.search("from repro.core import regions")
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert not _FORBIDDEN.search("from repro_torch.core import regions")


_SUBPACKAGE_PROBE = """
import importlib, pkgutil, sys
pkg = importlib.import_module(sys.argv[1])
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n.startswith("jaxlib.") or n == "repro" or n.startswith("repro."))
print(names, bad)
sys.exit(1 if bad or not names else 0)
"""


@pytest.mark.parametrize("package", ["optim", "runtime", "data", "checkpoint",
                                     "parallel"])
def test_training_subpackages_load_no_jax_and_no_repro(package):
    """The training slice's subpackages, each imported alone in a fresh
    interpreter: every module of it loads, and neither JAX nor the JAX
    package comes with them."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _SUBPACKAGE_PROBE,
                           f"repro_torch.{package}"], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _entry_points():
    from repro_torch.apps import from_numpy, mriq, tdfir
    from repro_torch.apps.decode_attn import make_decode_program
    from repro_torch.core.device import resolve_device
    from repro_torch.launch import (fig4_offload, loop_extraction,
                                    replanning, serve, strategies)
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.offload_program import make_lm_program
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train, train_lm
    from repro_torch.parallel.rules import ParallelismConfig
    from repro_torch.runtime.loop import run_training
    x = np.zeros((2, 8), np.complex64)
    return {
        "resolve_device": lambda: resolve_device(),
        "tdfir.make_program": lambda: tdfir.make_program(),
        "mriq.make_program": lambda: mriq.make_program(),
        "from_numpy": lambda: from_numpy("tdfir", [x, x]),
        "fig4_offload.main": lambda: fig4_offload.main(["--app", "mriq",
                                                        "--no-cache"]),
        "make_lm_program": lambda: make_lm_program("mistral-nemo-12b"),
        "make_lm_program falcon-mamba-7b":
            lambda: make_lm_program("falcon-mamba-7b"),
        "make_lm_program recurrentgemma-2b":
            lambda: make_lm_program("recurrentgemma-2b"),
        "make_decode_program": lambda: make_decode_program(),
        "params_from_numpy": lambda: params_from_numpy({"w": x}),
        "serve.main": lambda: serve.main(["--arch", "mistral-nemo-12b",
                                          "--reduced"]),
        "serve.main recurrentgemma-2b": lambda: serve.main(
            ["--arch", "recurrentgemma-2b", "--reduced"]),
        "loop_extraction.main": lambda: loop_extraction.main(["--reduced"]),
        "strategies.main": lambda: strategies.main(["--reduced"]),
        "replanning.main": lambda: replanning.main([]),
        "serve.main --replan-on-drift": lambda: serve.main(
            ["--arch", "recurrentgemma-2b", "--reduced", "--replan-on-drift"]),
        "train.main": lambda: train.main(["--arch", "mistral-nemo-12b",
                                          "--reduced"]),
        "train_lm.main": lambda: train_lm.main(["--steps", "1"]),
        "run_training": lambda: run_training(
            get_config("mistral-nemo-12b").reduced(), ParallelismConfig(),
            None, iter([])),
    }


@pytest.mark.parametrize("entry", sorted(_entry_points()))
def test_entry_points_raise_without_cuda(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        _entry_points()[entry]()


def test_entry_points_run_on_the_cpu_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from repro_torch.apps import from_numpy, mriq
    from repro_torch.core.device import backend_name, resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    assert backend_name("cpu") == "cpu"
    assert mriq.make_program(device="cpu").device == torch.device("cpu")
    from repro_torch.launch import serve
    from repro_torch.models.offload_program import make_lm_program
    for arch in ("falcon-mamba-7b", "recurrentgemma-2b"):
        assert make_lm_program(arch, device="cpu").device == torch.device("cpu")
    serve.main(["--arch", "recurrentgemma-2b", "--reduced", "--device", "cpu",
                "--requests", "1", "--prompt-len", "4", "--new-tokens", "2"])
    x = np.zeros((2, 8), np.complex64)
    assert from_numpy("tdfir", [x, x], device="cpu")[0].device.type == "cpu"
