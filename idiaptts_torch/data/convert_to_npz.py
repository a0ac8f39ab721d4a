"""Convert raw binary float32 feature files to ``.npz`` archives: the
port's copy of ``idiaptts_tpu/data/convert_to_npz.py`` (numpy only).

Give it a directory, an extension and an optional feature dimension, and
every matching raw float32 file becomes ``<id>.npz`` with the feature
stored under the extension-derived key (what ``NpzDataReader`` loads).

Usage: ``python -m idiaptts_torch.data.convert_to_npz -d DIR -e EXT
[--dim N] [--key KEY] [-o DIR_OUT] [--delete_original]``.
"""

import argparse
import glob
import logging
import os

import numpy as np

logger = logging.getLogger(__name__)


def convert_dir(directory, ext, dim=None, key=None, dir_out=None,
                delete_original=False):
    """Convert every ``*.<ext>`` raw float32 file in ``directory``.

    Returns the list of written npz paths.
    """
    ext = ext.lstrip(".")
    key = key or ext
    dir_out = dir_out or directory
    os.makedirs(dir_out, exist_ok=True)
    written = []
    for path in sorted(glob.glob(os.path.join(directory, "*." + ext))):
        arr = np.fromfile(path, dtype=np.float32)
        if dim:
            if arr.size % dim:
                logger.warning("Skipping %s: size %d not divisible by "
                               "dim %d", path, arr.size, dim)
                continue
            arr = arr.reshape(-1, dim)
        else:
            arr = arr[:, None]
        id_name = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(dir_out, id_name + ".npz")
        tmp_path = out_path + ".tmp.npz"
        np.savez(tmp_path, **{key: arr})
        os.replace(tmp_path, out_path)
        written.append(out_path)
        if delete_original:
            os.remove(path)
    logger.info("Converted %d %s files in %s", len(written), ext,
                directory)
    return written


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-d", "--directory", required=True)
    parser.add_argument("-e", "--ext", required=True,
                        help="raw file extension, e.g. lf0, mcep")
    parser.add_argument("--dim", type=int, default=None,
                        help="feature dimension (omit for 1-D)")
    parser.add_argument("--key", default=None,
                        help="npz key (defaults to the extension)")
    parser.add_argument("-o", "--dir_out", default=None)
    parser.add_argument("--delete_original", action="store_true")
    args = parser.parse_args(argv)
    convert_dir(args.directory, args.ext, dim=args.dim, key=args.key,
                dir_out=args.dir_out,
                delete_original=args.delete_original)


if __name__ == "__main__":
    main()
