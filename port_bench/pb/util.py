"""Small shared pieces: seeds, the run's environment, the card, the
forbidden-module guard and the result line."""

import hashlib
import json
import os
import subprocess
import sys

# Top-level module names that may not be loaded in a benchmark process:
# the JAX package and its stack.  Compared whole, never by prefix (the
# port's own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "idiaptts_tpu")


class NoCard(RuntimeError):
    """The run found fewer cards than its cell asks for."""


def sub_seed(seed, tag):
    """A 63-bit seed for one purpose (``tag``) of a run's ``--seed``:
    any whole number, however large, gives a valid generator seed."""
    digest = hashlib.sha256("{}:{}".format(int(seed), tag).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def cache_root(root):
    """The fixed directory inside the checkout that holds every build and
    kernel cache of a run (the program's own kernel library stays in
    ``idiaptts_torch/_build/`` beside its sources)."""
    return os.path.join(root, ".port_bench_cache")


def prepare_environment(root, threads=4):
    """Environment of a benchmark process, set before torch is imported:
    caches at fixed paths inside the checkout, no flax in any library,
    few host threads."""
    cache = cache_root(root)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, str(threads))


def forbidden_loaded(modules=None):
    """Sorted top-level names of ``FORBIDDEN`` found in ``sys.modules``."""
    modules = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in modules
                   if name.split(".", 1)[0] in FORBIDDEN})


def require_cards(torch, count):
    """Raise :class:`NoCard` unless CUDA works and holds ``count`` cards."""
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < count:
        raise NoCard("the cell needs {} card(s), torch sees {}".format(
            count, torch.cuda.device_count()))


class PowerLimit:
    """``name, power.limit`` of card 0 as nvidia-smi prints it, asked at
    construction and read by ``text()``, so that set-up does not wait on
    it; "not read" where nvidia-smi does not answer."""

    def __init__(self):
        self.read = None
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def text(self):
        if self.read is None:
            self.read = "not read"
            if self.proc is not None:
                try:
                    out = self.proc.communicate(timeout=30)[0]
                    self.read = out.strip().splitlines()[0].strip()
                except (subprocess.SubprocessError, IndexError):
                    self.proc.kill()
                    self.proc.wait()
        return self.read



def device_record(torch, count, peak_bytes):
    """The result line's ``device`` object."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": int(count), "memory_peak_bytes": int(peak_bytes)}


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def emit(result, checks):
    """Print each compared number beside its limit as the last lines of
    standard error, then the result line (``checks`` its last key) as
    the last line of standard output."""
    for name, entry in checks.items():
        log("check {} {!r} limit {!r} {}".format(
            name, entry["value"], entry["limit"],
            "ok" if entry.get("ok") else "FAILED"))
    line = dict(result)
    line["checks"] = {name: {"value": entry["value"],
                             "limit": entry["limit"]}
                      for name, entry in checks.items()}
    print(json.dumps(line), flush=True)
