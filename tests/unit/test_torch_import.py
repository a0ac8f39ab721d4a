"""The port imports without JAX, without the JAX package and without
Triton.

Runs in a subprocess: this pytest process has imported jax already
(tests/conftest.py), so the check blocks ``jax``, ``jaxlib``, ``flax``,
``optax`` and ``idiaptts_tpu`` in ``sys.meta_path`` of a fresh
interpreter, imports every module of the port (and ``chip_smoke.py``),
and asserts that none of them pulled in Triton.  A second check lists
the port's modules from disk, so a new module cannot be left out.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

MODULES = [
    "idiaptts_torch",
    "idiaptts_torch.hparams",
    "idiaptts_torch.ops.dispatch",
    "idiaptts_torch.ops.cuda_mlpg",
    "idiaptts_torch.ops.mlpg",
    "idiaptts_torch.ops.cuda_lstm",
    "idiaptts_torch.ops.mcep",
    "idiaptts_torch.ops.world.d4c",
    "idiaptts_torch.ops.world.synthesis",
    "idiaptts_torch.ops.mulaw",
    "idiaptts_torch.ops.audio_io",
    "idiaptts_torch.ops.interpolation",
    "idiaptts_torch.ops.cuda_wavenet",
    "idiaptts_torch.models.config",
    "idiaptts_torch.models.losses",
    "idiaptts_torch.models.named",
    "idiaptts_torch.models.rnn_dyn",
    "idiaptts_torch.models.wavenet",
    "idiaptts_torch.models.convert",
    "idiaptts_torch.synth.pipeline",
    "idiaptts_torch.synth.server",
    "idiaptts_torch.synth.synthesiser",
    "idiaptts_torch.synth.metrics",
    "idiaptts_torch.data.normalisation",
    "idiaptts_torch.data.reader",
    "idiaptts_torch.data.dataset",
    "idiaptts_torch.data.questions",
    "idiaptts_torch.data.world_feat",
    "idiaptts_torch.train.schedulers",
    "idiaptts_torch.train.model_handler_base",
    "idiaptts_torch.train.handler",
    "idiaptts_torch.train.trainer",
    "idiaptts_torch.train.acoustic",
    "chip_smoke",
]

_SCRIPT = r"""
import importlib, importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "idiaptts_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in BLOCKED + ("triton",))
assert not bad, bad
print("imported", len(sys.argv) - 1, "modules")
"""


def _run(*args, cwd=REPO, repo_on_path=True):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    if repo_on_path:
        env["PYTHONPATH"] = REPO
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax_or_triton():
    proc = _run("-c", _SCRIPT, *MODULES)
    assert proc.returncode == 0, proc.stderr
    assert "imported {} modules".format(len(MODULES)) in proc.stdout


def test_every_port_module_is_checked():
    """Every module file of the port (package ``__init__`` files aside)
    is in MODULES."""
    on_disk = set()
    for root, _, files in os.walk(os.path.join(REPO, "idiaptts_torch")):
        for name in files:
            if name.endswith(".py") and name != "__init__.py":
                rel = os.path.relpath(os.path.join(root, name), REPO)
                on_disk.add(rel[:-3].replace(os.sep, "."))
    assert not sorted(on_disk - set(MODULES))


def test_chip_smoke_refuses_to_run_without_cuda(tmp_path):
    """No CUDA device: a non-zero exit and no result line.  The same
    holds for the script alone, away from the repository."""
    proc = _run(os.path.join(REPO, "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    lone = tmp_path / "chip_smoke.py"
    with open(os.path.join(REPO, "chip_smoke.py")) as src:
        lone.write_text(src.read())
    env_free = _run(str(lone), cwd=str(tmp_path), repo_on_path=False)
    assert env_free.returncode != 0
    assert '"ok"' not in env_free.stdout
