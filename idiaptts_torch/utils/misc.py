"""Misc utilities: the port of ``idiaptts_tpu/utils/misc.py``.

Host helpers (``makedirs_safe``, ``file_len``, ``get_id_list``,
``log_git_hash``, ``get_memory_usage_mb``, ``ndarray_to_string``,
``select_skip``, ``ncr``, ``local_modification_time``, the pretty
printers, ``parse_int_set``) and ``get_device_memory_stats``, which reads
``torch.cuda.memory_stats`` of each visible card (an empty dict without
one).
"""

import logging
import math
import os
import resource
import socket
import subprocess
from datetime import datetime, timezone

import numpy as np

from idiaptts_torch.models.rnn_dyn import parse_int_set  # noqa: F401

logger = logging.getLogger(__name__)


def makedirs_safe(path):
    os.makedirs(path, exist_ok=True)
    return path


def file_len(path):
    with open(path) as f:
        return sum(1 for _ in f)


def get_id_list(file_id_list_path):
    with open(file_id_list_path) as f:
        return [line.strip() for line in f if line.strip()]


def log_git_hash(repo_dir=None):
    """Log the host name and the checkout's short git hash ("unknown"
    outside a git checkout); returns the hash."""
    try:
        git_hash = subprocess.check_output(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=repo_dir or os.path.dirname(os.path.abspath(__file__)),
            stderr=subprocess.DEVNULL).decode().strip()
    except (subprocess.CalledProcessError, FileNotFoundError):
        git_hash = "unknown"
    logger.info("Running on %s with git hash %s",
                socket.gethostname(), git_hash)
    return git_hash


def get_memory_usage_mb():
    """Peak CPU RSS of this process in MB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def get_device_memory_stats():
    """{"cuda:<i>": {"bytes_in_use", "bytes_limit"}} for every visible
    card, from ``torch.cuda.memory_stats`` and the card's total memory;
    an empty dict without CUDA."""
    import torch
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for index in range(torch.cuda.device_count()):
        device = torch.device("cuda", index)
        s = torch.cuda.memory_stats(device)
        stats[str(device)] = {
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "bytes_limit": torch.cuda.get_device_properties(
                device).total_memory,
        }
    return stats


def ndarray_to_string(array, precision=4):
    return np.array_str(np.asarray(array), precision=precision,
                        suppress_small=True)


def select_skip(iterable, select, skip, start_index=0):
    """Keep ``select`` elements of every ``select + skip``, counted from
    ``start_index``."""
    return [x for i, x in enumerate(iterable)
            if (i - start_index) % (select + skip) < select]


def ncr(n, r):
    return math.comb(n, r)


def local_modification_time(file_path):
    """The file's modification time in local time, as
    ``YYYY-MM-DD HH:MM:SS``."""
    utc = datetime.fromtimestamp(os.path.getmtime(file_path),
                                 timezone.utc)
    return utc.astimezone().strftime("%Y-%m-%d %H:%M:%S")


def pretty_print_decimal_places(value):
    """The decimal digits of a float as a string."""
    return str(np.format_float_positional(value).split(".")[1])


def pretty_print_nested(obj, indent=0):
    pad = "  " * indent
    if isinstance(obj, dict):
        return "\n".join("{}{}:\n{}".format(
            pad, key, pretty_print_nested(value, indent + 1))
            for key, value in obj.items())
    if isinstance(obj, (list, tuple)):
        return "\n".join(pretty_print_nested(v, indent) for v in obj)
    if isinstance(obj, np.ndarray):
        return pad + ndarray_to_string(obj)
    return pad + repr(obj)
