"""ctypes bridge to the native C++ question matcher: the port of
``idiaptts_tpu/data/native_questions.py``.

Builds ``native/question_matcher.cpp`` (read where it lies in the
repository, never edited) with ``g++ -O2 -shared`` on first use into
``idiaptts_torch/_build/``, named by a hash of the source and flags so
an edit rebuilds, and exposes :class:`NativeQuestionSet` with the same
``match`` API as the Python :class:`idiaptts_torch.data.questions.QuestionSet`.
This is host code: it runs on the CPU on every machine.  When the
toolchain is unavailable, ``QuestionSet.native()`` returns None and the
Python matcher, whose answers are identical, takes its place.

``matches`` counts the labels matched natively, so a run can show that
its question generation went through the C++ matcher.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SRC = os.path.join(_REPO, "native", "question_matcher.cpp")
BUILD_DIR = os.path.join(_REPO, "idiaptts_torch", "_build")
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None
# Labels matched by the native matcher since import (or the last reset).
matches = 0


def lib_path():
    """The shared library's path for the current source and flags."""
    digest = hashlib.sha256()
    with open(SRC, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, "libquestion_matcher_{}.so".format(
        digest.hexdigest()[:16]))


def _build(path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_lib = os.path.join(tmp, "lib.so")
        subprocess.run(["g++", *_FLAGS, SRC, "-o", tmp_lib], check=True,
                       capture_output=True)
        os.replace(tmp_lib, path)


def get_lib():
    """The loaded matcher library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not os.path.isfile(path):
            _build(path)
        lib = ctypes.CDLL(path)
        lib.qm_create.restype = ctypes.c_void_p
        lib.qm_destroy.argtypes = [ctypes.c_void_p]
        lib.qm_add_binary.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int]
        lib.qm_add_continuous.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.qm_dict_size.argtypes = [ctypes.c_void_p]
        lib.qm_dict_size.restype = ctypes.c_int
        lib.qm_match.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return lib


def reset_count():
    global matches
    matches = 0


class NativeQuestionSet:
    """Drop-in accelerator for QuestionSet.match."""

    def __init__(self, question_set):
        """question_set: a parsed
        :class:`idiaptts_torch.data.questions.QuestionSet` (its raw
        patterns are reused, not its compiled regexes)."""
        self.lib = get_lib()
        self.handle = ctypes.c_void_p(self.lib.qm_create())
        for key, raw_patterns in question_set.raw_binary:
            joined = "\n".join(raw_patterns).encode()
            self.lib.qm_add_binary(self.handle, joined,
                                   1 if "LL-" in key else 0)
        for _, raw_pattern in question_set.raw_continuous:
            self.lib.qm_add_continuous(self.handle, raw_pattern.encode())
        # Output layout: the binary block, then the continuous block, as
        # the Python matcher orders them.
        self.dict_size = self.lib.qm_dict_size(self.handle)

    def match(self, label):
        global matches
        out = np.zeros(self.dict_size, np.float32)
        self.lib.qm_match(self.handle, label.encode(),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        matches += 1
        return out

    def match_many(self, labels):
        return np.stack([self.match(label) for label in labels]) \
            if labels else np.zeros((0, self.dict_size), np.float32)

    def __del__(self):
        try:
            self.lib.qm_destroy(self.handle)
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass
