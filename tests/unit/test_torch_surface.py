"""The port's module surface against the JAX package's, by ``ast``.

Every module of ``idiaptts_tpu`` has a module of the same path in
``idiaptts_torch`` (the JAX recipes under ``egs/`` map to
``idiaptts_torch/egs/``), every public top-level definition (function,
class or assignment; not an import) has one of the same name there, and
every public member of a class has one in the port's class of that name
or its bases.  A name without a counterpart fails the test unless it is
in ``EXCLUDED`` with the reason it is not ported.
"""

import ast
import functools
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: JAX module (relative path) -> the port's, where the paths differ.
MODULE_MAP = {
    "egs/recipe_common.py": "egs/recipe_common.py",
    "egs/ljspeech_demo/run.py": "egs/ljspeech_demo.py",
    "egs/intonation_demo/run.py": "egs/intonation_demo.py",
}

#: Module loggers are no API.
IGNORED_NAMES = {"logger"}

#: (JAX module, name or "<module>") -> why the port has no counterpart.
EXCLUDED = {
    ("ops/pallas_lstm.py", "<module>"):
        "Pallas kernels: the hand CUDA kernels csrc/bilstm_proj.cu, "
        "bilstm_recurrence.cu and bilstm_bwd.cu behind ops/cuda_lstm.py",
    ("ops/pallas_mlpg.py", "<module>"):
        "Pallas kernels: csrc/mlpg_oneshot.cu and banded_solve.cu behind "
        "ops/cuda_mlpg.py",
    ("ops/pallas_wavenet.py", "<module>"):
        "Pallas kernel: csrc/wavenet_sampler.cu behind ops/cuda_wavenet.py",
    ("ops/pallas_ctx.py", "<module>"):
        "the Pallas dispatch context; ops/dispatch.py routes the port's "
        "kernels by device",
    ("ops/mlpg.py", "mlpg_jax"):
        "named after its library: the port's is ops/mlpg.py:mlpg_torch",
    ("synth/pipeline.py", "FusedAcousticPipeline.stage_jits"):
        "jit-compiled stages; the port has no jit and exposes the stages "
        "as model_stage, mlpg_stage and vocoder_stage",
    ("models/losses.py", "nn_sigmoid"):
        "a wrapper of jax.nn.sigmoid; the port calls torch.sigmoid",
    ("models/losses.py", "math_gamma"):
        "a wrapper of math.gamma; the port calls math.gamma",
}


def _names(path):
    """(public top-level names, {class: (members, base names)})."""
    with open(path) as f:
        tree = ast.parse(f.read())
    top, classes = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            top.add(node.name)
        elif isinstance(node, ast.Assign):
            top.update(t.id for t in node.targets
                       if isinstance(t, ast.Name))
        if isinstance(node, ast.ClassDef):
            members = set()
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                    members.add(b.name)
                elif isinstance(b, ast.Assign):
                    members.update(t.id for t in b.targets
                                   if isinstance(t, ast.Name))
            classes[node.name] = (members, [ast.unparse(x).split(".")[-1]
                                            for x in node.bases])
    return top, classes


def _walk(*roots):
    out = {}
    for root in roots:
        base = os.path.join(REPO, root)
        for dirpath, _, files in os.walk(base):
            for f in files:
                if f.endswith(".py") and f != "__init__.py":
                    path = os.path.join(dirpath, f)
                    rel = os.path.relpath(path, REPO if root == "egs"
                                          else base)
                    out[rel] = _names(path)
    return out


@functools.lru_cache(maxsize=None)
def missing_names():
    """Every (JAX module, name) without a counterpart in the port."""
    jax = _walk("idiaptts_tpu", "egs")
    port = _walk("idiaptts_torch")
    port_classes = {}
    for _, classes in port.values():
        for name, value in classes.items():
            port_classes.setdefault(name, []).append(value)

    def members(name, seen=()):
        out = set()
        for own, bases in port_classes.get(name, []):
            out |= own
            for b in bases:
                if b not in seen:
                    out |= members(b, seen + (name,))
        return out

    missing = []
    for rel, (top, classes) in sorted(jax.items()):
        target = MODULE_MAP.get(rel, rel)
        if target not in port:
            missing.append((rel, "<module>"))
            continue
        port_top, _ = port[target]
        missing += [(rel, n) for n in sorted(top)
                    if not n.startswith("_") and n not in IGNORED_NAMES
                    and n not in port_top]
        for cls, (own, _) in sorted(classes.items()):
            if cls.startswith("_") or cls not in port_top:
                continue
            have = members(cls)
            missing += [(rel, cls + "." + n) for n in sorted(own)
                        if not n.startswith("_") and n not in have]
    return tuple(missing)


def test_every_public_name_has_a_counterpart_or_a_reason():
    unexplained = [m for m in missing_names() if m not in EXCLUDED]
    assert not unexplained, unexplained


def test_every_exclusion_is_still_needed():
    """An exclusion whose name the port now has is stale."""
    missing = set(missing_names())
    assert not [k for k in EXCLUDED if k not in missing]


@pytest.mark.parametrize("rel,name", [
    ("ops/audio_io.py", "rms_normalise"),
    ("ops/audio_io.py", "highpass_filter"),
    ("hparams.py", "ExtendedHParams.get_value"),
    ("hparams.py", "ExtendedHParams.enable_backwards_compatibility"),
    ("train/trainer.py", "ModularTrainer.sanity_check_train"),
    ("train/trainer.py", "ModularTrainer.log_validation_set"),
    ("train/trainer.py", "ModularTrainer.log_test_set"),
    ("train/trainer.py", "ModularTrainer.log_memory"),
    ("train/trainer.py", "ModularTrainer.log_losses"),
    ("train/trainer.py", "ModularTrainer.get_labels"),
    ("train/trainer.py", "ModularTrainer.gen_output"),
    ("train/trainer.py", "ModularTrainer.plot1d"),
    ("train/trainer.py", "ModularTrainer.plot_specshow"),
    ("data/dataset.py", "DatareadersDataset.get_input_dim"),
    ("data/dataset.py", "DatareadersDataset.get_datareader_by_name"),
    ("data/world_feat.py", "WorldFeatLabelGen.load_flags"),
    ("data/questions.py", "main"),
    ("data/phonemes.py", "main"),
    ("train/handler.py", "ModularModelHandler.setup_mesh"),
    ("synth/pipeline.py", "<module>"),
    ("parallel/mesh.py", "initialise_multihost"),
    ("egs/ljspeech_demo/run.py", "stage8_wavenet"),
    ("parallel/mesh.py", "make_2d_mesh"),
    ("parallel/mesh.py", "make_param_shardings"),
    ("parallel/mesh.py", "make_tp_train_step"),
])
def test_the_gaps_of_earlier_slices_are_closed(rel, name):
    assert (rel, name) not in missing_names()
