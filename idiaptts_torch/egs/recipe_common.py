"""Helpers shared by the port's recipes (the port of
``egs/recipe_common.py``): question-file discovery, the question-vector
width convention, the WORLD extraction stage, the Kaldi-style stage loop
and the arguments every recipe takes."""

import glob
import logging
import os

logger = logging.getLogger(__name__)

#: questions = answered QS/CQS entries + 9 frame-position features
#: (the QuestionLabelGen layout).
NUM_SUBPHONE_FEATS = 9

#: The repository's own fixture corpus (six 16 kHz utterances with their
#: labels), the recipes' default ``--fixtures``.
DEFAULT_FIXTURES = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "tests",
    "fixtures"))


def question_file(fixtures_dir):
    heds = sorted(glob.glob(os.path.join(fixtures_dir, "*.hed")))
    if not heds:
        raise FileNotFoundError("no .hed question file in " + fixtures_dir)
    return heds[0]


def num_questions(fixtures_dir):
    from idiaptts_torch.data.questions import QuestionSet
    return (QuestionSet(question_file(fixtures_dir)).dict_size
            + NUM_SUBPHONE_FEATS)


def read_ids(fixtures_dir):
    """The corpus's utterance ids (``file_id_list.txt``, directories
    stripped)."""
    with open(os.path.join(fixtures_dir, "file_id_list.txt")) as f:
        return [line.strip().split("/")[-1] for line in f if line.strip()]


def stage_world(fixtures_dir, work_dir, ids, num_coded_sps, device):
    """Extract WORLD features (+cmp and statistics) into
    ``<work_dir>/WORLD`` on ``device``."""
    from idiaptts_torch.data.world_feat import WorldFeatLabelGen
    dir_world = os.path.join(work_dir, "WORLD")
    gen = WorldFeatLabelGen(dir_labels=dir_world, add_deltas=True,
                            num_coded_sps=num_coded_sps, device=device)
    gen.gen_data(os.path.join(fixtures_dir, "database", "wav"),
                 dir_out=dir_world, id_list=ids)
    logger.info("WORLD features in %s", dir_world)
    return dir_world


def add_common_arguments(parser, stop_stage, epochs):
    parser.add_argument("--work_dir", required=True)
    parser.add_argument("--fixtures", default=DEFAULT_FIXTURES)
    parser.add_argument("--stage", type=int, default=1)
    parser.add_argument("--stop_stage", type=int, default=stop_stage)
    parser.add_argument("--epochs", type=int, default=epochs)
    parser.add_argument("--device", default="cuda",
                        help="where features, training and synthesis run "
                             "(cuda, or cpu for the plain PyTorch path)")


def run_stages(stages, args, *extra):
    """Kaldi-style ``--stage``/``--stop_stage`` loop with range
    validation; returns {stage: its result}."""
    lo, hi = min(stages), max(stages)
    if args.stage not in stages or args.stop_stage not in stages:
        raise SystemExit("--stage/--stop_stage must be in %d..%d (got "
                         "%d..%d)" % (lo, hi, args.stage, args.stop_stage))
    results = {}
    for n in range(args.stage, args.stop_stage + 1):
        logger.info("===== stage %d =====", n)
        results[n] = stages[n](args, *extra)
    return results
