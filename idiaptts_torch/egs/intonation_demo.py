"""End-to-end GCR intonation-modelling demo recipe: the port of
``egs/intonation_demo/run.py`` on the repository's fixture corpus.

Stages (Kaldi-style ``--stage N`` resume):
  1  extract WORLD features (lf0 and vuv are what the atoms need)
  2  question labels from HTS state-aligned labels
  3  wcad atom and phrase decomposition of the LF0 contours
  4  train the atom [amps, pos, vuv] model; benchmark F0-RMSE / VDE from
     the reconstructed LF0; draw an atom-spike figure
  5  flat neural-filter training on flat LF0, adopting the stage-4 atom
     checkpoint (training the atom phase first when stage 4 was skipped)
  6  the phrase model on the full LF0 track, adopting the stage-5 flat
     checkpoint the same way, and a final benchmark

Everything runs on ``--device`` (the card by default; ``--device cpu``
runs the plain PyTorch path).  The models are small as published.

Usage:
  python -m idiaptts_torch.egs.intonation_demo --work_dir DIR [--stage 1]
      [--stop_stage 6] [--epochs 5] [--fixtures DIR] [--device cuda]
"""

import argparse
import glob
import importlib.util
import logging
import os

from idiaptts_torch.egs import recipe_common

logger = logging.getLogger("intonation_demo")

NUM_SPS = 20
THETAS = [0.03, 0.06, 0.09, 0.12, 0.15]


def _atom_dir(args):
    return os.path.join(args.work_dir,
                        "wcad-" + "_".join("%.3f" % t for t in THETAS))


def stage1_world(args, ids):
    return recipe_common.stage_world(args.fixtures, args.work_dir, ids,
                                     NUM_SPS, args.device)


def stage2_labels(args, ids):
    from idiaptts_torch.data.questions import QuestionLabelGen
    QuestionLabelGen.gen_data(
        os.path.join(args.fixtures, "labels", "label_state_align"),
        recipe_common.question_file(args.fixtures),
        dir_out=os.path.join(args.work_dir, "questions"), id_list=ids)
    logger.info("question labels done")


def stage3_atoms(args, ids):
    from idiaptts_torch.data import wcad
    wcad.gen_data(os.path.join(args.work_dir, "WORLD"), THETAS,
                  _atom_dir(args), ids, min_amp=0.08,
                  file_id_list_name="file_id_list")
    logger.info("atom decomposition in %s", _atom_dir(args))


def _dirs(args):
    return dict(
        dir_question_labels=os.path.join(args.work_dir, "questions"),
        dir_atom_labels=_atom_dir(args),
        dir_world_features=os.path.join(args.work_dir, "WORLD"))


def _base_hparams(cls, args, name, load_checkpoint=False):
    hp = cls.create_hparams()
    hp.num_questions = recipe_common.num_questions(args.fixtures)
    hp.thetas = THETAS
    hp.out_dir = os.path.join(args.work_dir, "exp")
    hp.model_name = name
    hp.epochs = args.epochs
    hp.batch_size_train = 3
    hp.batch_size_val = 6
    hp.learning_rate = 0.001
    hp.seed = 1
    hp.test_set_perc = 0.0
    hp.val_set_perc = 0.25
    hp.use_best_as_final_model = False
    hp.device = args.device
    if load_checkpoint:
        hp.load_newest_checkpoint = True
    return hp


def _has_checkpoint(args, name):
    return bool(glob.glob(os.path.join(args.work_dir, "exp", name, "nn",
                                       "params_*")))


def _atom_trainer(args, ids, load_checkpoint=False):
    from idiaptts_torch.models.rnn_dyn import convert_legacy_string
    from idiaptts_torch.train.atom_trainers import \
        AtomVUVDistPosModelTrainer
    hp = _base_hparams(AtomVUVDistPosModelTrainer, args, "atoms",
                       load_checkpoint)
    trainer = AtomVUVDistPosModelTrainer(hp, list(ids), **_dirs(args))
    cfg = convert_legacy_string("RNNDYN-1_RELU_64-1_FC_7", hp.num_questions)
    cfg.input_names = ("questions",)
    cfg.output_names = ("pred_atoms",)
    trainer.init(hp, model_config=cfg)
    return trainer, hp


def stage4_atom_model(args, ids):
    trainer, hp = _atom_trainer(args, ids)
    trainer.train(hp)
    trainer.save_checkpoint(hp, last=True)
    f0_rmse, vde = trainer.benchmark(hp, trainer.id_list_train)
    logger.info("atom benchmark: F0-RMSE %.2f Hz, VDE %.3f", f0_rmse, vde)
    hp.synth_dir = os.path.join(args.work_dir, "figures")
    hp.min_atom_amp = 0.05
    if importlib.util.find_spec("matplotlib") is None:
        logger.warning("matplotlib is not installed: no atom figures")
        paths = []
    else:
        paths = trainer.gen_figure(hp, trainer.id_list_train[:2])
        logger.info("atom figures: %s", ", ".join(paths))
    return {"scores": (f0_rmse, vde), "figures": paths}


def _flat_trainer(args, ids, load_checkpoint=False):
    """The flat trainer, whose atom sub-model comes from the stage-4
    checkpoint when there is one."""
    from idiaptts_torch.train.atom_trainers import \
        AtomNeuralFilterModelTrainer
    atom_trainer, atom_hp = _atom_trainer(args, ids, load_checkpoint=True)
    flat_hp = _base_hparams(AtomNeuralFilterModelTrainer, args, "flat",
                            load_checkpoint)
    flat = AtomNeuralFilterModelTrainer(flat_hp, list(ids), **_dirs(args))
    flat.init_atom(flat_hp, atom_trainer)
    flat.init(flat_hp)
    return flat, flat_hp, atom_hp, _has_checkpoint(args, "atoms")


def stage5_flat_filters(args, ids):
    flat, flat_hp, atom_hp, atom_pretrained = _flat_trainer(args, ids)
    if atom_pretrained:
        logger.info("adopting the stage-4 atom checkpoint")
        flat.adopt_atom_params()
    else:
        logger.info("no atom checkpoint found; training the atom phase")
        flat.train_atom(atom_hp)
    flat.train(flat_hp)
    flat.save_checkpoint(flat_hp, last=True)
    f0_rmse, vde = flat.benchmark(flat_hp, flat.id_list_train)
    logger.info("flat neural-filter benchmark: F0-RMSE %.2f Hz, VDE %.3f",
                f0_rmse, vde)
    return {"scores": (f0_rmse, vde)}


def stage6_phrase(args, ids):
    from idiaptts_torch.train.atom_trainers import \
        PhraseAtomNeuralFilterModelTrainer
    flat, flat_hp, atom_hp, atom_pretrained = _flat_trainer(
        args, ids, load_checkpoint=True)
    flat_pretrained = _has_checkpoint(args, "flat")
    phrase_hp = _base_hparams(PhraseAtomNeuralFilterModelTrainer, args,
                              "phrase")
    phrase_hp.add_hparams(phrase_bias_init=5.2)
    phrase = PhraseAtomNeuralFilterModelTrainer(phrase_hp, list(ids),
                                                **_dirs(args))
    phrase.init_flat(phrase_hp, flat)
    phrase.init(phrase_hp)
    if flat_pretrained:
        logger.info("adopting the stage-5 flat checkpoint")
        phrase.adopt_flat_params()
    else:
        logger.info("no flat checkpoint found; training phases 0+1")
        if atom_pretrained:
            flat.adopt_atom_params()
        else:
            phrase.train_atom(atom_hp)
        phrase.train_flat(flat_hp)
    phrase.train(phrase_hp)
    phrase.save_checkpoint(phrase_hp, last=True)
    f0_rmse, vde = phrase.benchmark(phrase_hp, phrase.id_list_train)
    logger.info("phrase model benchmark: F0-RMSE %.2f Hz, VDE %.3f",
                f0_rmse, vde)
    return {"scores": (f0_rmse, vde)}


STAGES = {1: stage1_world, 2: stage2_labels, 3: stage3_atoms,
          4: stage4_atom_model, 5: stage5_flat_filters, 6: stage6_phrase}


def main(argv=None):
    """Run the stages ``--stage`` to ``--stop_stage``; returns {stage:
    its result}."""
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    recipe_common.add_common_arguments(parser, stop_stage=6, epochs=5)
    args = parser.parse_args(argv)
    os.makedirs(args.work_dir, exist_ok=True)
    return recipe_common.run_stages(STAGES, args,
                                    recipe_common.read_ids(args.fixtures))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main()
