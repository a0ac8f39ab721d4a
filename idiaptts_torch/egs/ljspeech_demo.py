"""End-to-end LJSpeech-style demo recipe: the port of
``egs/ljspeech_demo/run.py`` on the repository's fixture corpus.

Stages (Kaldi-style ``--stage N`` resume):
  1  extract WORLD features and their statistics
  2  question labels from HTS state-aligned labels, and phone durations
  3  train the duration model
  4  train the acoustic model
  5  benchmark the acoustic model (MCD / F0-RMSE / VDE / BAP)
  6  synthesise two utterances from their labels through the fused
     pipeline (acoustic model -> MLPG -> WORLD vocoder)
  7  serve every utterance concurrently through ``trainer.serve()``'s
     batching ``SynthesisServer``
  8  (``--stop_stage 8``) train a WaveNet vocoder on the corpus, export
     it for vocoding and neural-vocode one utterance

Everything runs on ``--device`` (the card by default; ``--device cpu``
runs the plain PyTorch path).  The acoustic model is the Interspeech'18
``RNNDYN-2_RELU_1024-3_BiLSTM_512-1_FC_67`` and WaveNet
``WaveNetWrapper.Config``'s defaults, unless ``--small_models`` asks for
narrow ones (for CPU runs).

Usage:
  python -m idiaptts_torch.egs.ljspeech_demo --work_dir DIR [--stage 1]
      [--stop_stage 7] [--epochs 8] [--fixtures DIR] [--device cuda]
      [--small_models]
"""

import argparse
import logging
import os

import numpy as np

from idiaptts_torch.egs import recipe_common

logger = logging.getLogger("ljspeech_demo")

NUM_SPS = 20
SMALL_ACOUSTIC = "RNNDYN-1_RELU_128-1_BiLSTM_64-1_FC_67"


def stage1_world(args, ids):
    return recipe_common.stage_world(args.fixtures, args.work_dir, ids,
                                     NUM_SPS, args.device)


def stage2_labels(args, ids):
    from idiaptts_torch.data.phonemes import PhonemeDurationLabelGen
    from idiaptts_torch.data.questions import QuestionLabelGen
    label_dir = os.path.join(args.fixtures, "labels", "label_state_align")
    QuestionLabelGen.gen_data(
        label_dir, recipe_common.question_file(args.fixtures),
        dir_out=os.path.join(args.work_dir, "questions"), id_list=ids)
    PhonemeDurationLabelGen.gen_data(
        label_dir, dir_out=os.path.join(args.work_dir, "dur"), id_list=ids)
    logger.info("questions + durations done")


def _dur_trainer(args, ids):
    from idiaptts_torch.data.normalisation import MinMaxExtractor
    from idiaptts_torch.data.phonemes import PhonemeDurationLabelGen
    from idiaptts_torch.data.questions import QuestionLabelGen
    from idiaptts_torch.train.duration import DurationModelTrainer

    # Phone-level questions (the first frame of each phone).
    dir_q_phone = os.path.join(args.work_dir, "questions_phone")
    num_questions = recipe_common.num_questions(args.fixtures)
    if not os.path.isdir(dir_q_phone):
        os.makedirs(dir_q_phone, exist_ok=True)
        extractor = MinMaxExtractor()
        for id_name in ids:
            q = QuestionLabelGen.load_sample(
                id_name, os.path.join(args.work_dir, "questions"),
                num_questions=num_questions)
            dur = PhonemeDurationLabelGen.load_sample(
                id_name, os.path.join(args.work_dir, "dur"))
            frames = dur.sum(axis=1).astype(np.int64)
            starts = np.minimum(np.cumsum(frames) - frames, len(q) - 1)
            phone_q = q[starts]
            extractor.add_sample(phone_q)
            phone_q.astype(np.float32).tofile(
                os.path.join(dir_q_phone, id_name + ".questions"))
        extractor.save(os.path.join(dir_q_phone, "all"))

    hparams = DurationModelTrainer.create_hparams()
    hparams.num_questions = num_questions
    hparams.out_dir = os.path.join(args.work_dir, "dur_model")
    hparams.model_name = "duration"
    hparams.epochs = args.epochs
    hparams.batch_size_train = 4
    hparams.seed = 1
    hparams.test_set_perc = 0.0
    hparams.val_set_perc = 0.25
    hparams.device = args.device
    # Stage-3 reruns resume training on the existing checkpoint.
    hparams.load_newest_checkpoint = True
    trainer = DurationModelTrainer(
        hparams, ids, dir_phoneme_labels=dir_q_phone,
        dir_durations=os.path.join(args.work_dir, "dur"))
    return trainer, hparams


def stage3_duration(args, ids):
    trainer, hparams = _dur_trainer(args, ids)
    _log_resume_state(hparams, "stage 3 (duration)")
    trainer.init(hparams)
    val_loss, train_loss = trainer.train(hparams)
    logger.info("duration model trained")
    return {"val_loss": val_loss, "train_loss": train_loss}


def _log_resume_state(hparams, what):
    nn_dir = os.path.join(hparams.out_dir, hparams.model_name,
                          hparams.get("networks_dir", "nn"))
    if os.path.isdir(nn_dir) and os.listdir(nn_dir):
        logger.info("%s: existing checkpoint in %s; training resumes on "
                    "top of it; use a fresh --work_dir to retrain from "
                    "scratch.", what, nn_dir)


def _acoustic_trainer(args, ids, strict_load=False):
    from idiaptts_torch.train.acoustic import AcousticModelTrainer
    hparams = AcousticModelTrainer.create_hparams()
    hparams.num_questions = recipe_common.num_questions(args.fixtures)
    hparams.num_coded_sps = NUM_SPS
    hparams.out_dir = os.path.join(args.work_dir, "am")
    hparams.model_name = "acoustic"
    hparams.epochs = args.epochs
    hparams.batch_size_train = 2
    hparams.batch_size_val = 9
    hparams.batch_size_benchmark = 9
    hparams.seed = 1
    hparams.test_set_perc = 0.0
    hparams.val_set_perc = 0.25
    hparams.synth_fs = 16000
    hparams.device = args.device
    # Later stages demand the trained model (strict); stage 4 loads
    # leniently, so a fresh work_dir trains from scratch.
    if strict_load:
        hparams.load_from_checkpoint = True
    else:
        hparams.load_newest_checkpoint = True
    trainer = AcousticModelTrainer(
        hparams, ids,
        dir_question_labels=os.path.join(args.work_dir, "questions"),
        dir_world_features=os.path.join(args.work_dir, "WORLD"))
    return trainer, hparams


def _init_acoustic(args, trainer, hparams):
    if args.small_models:
        from idiaptts_torch.models.rnn_dyn import convert_legacy_string
        cfg = convert_legacy_string(SMALL_ACOUSTIC,
                                    recipe_common.num_questions(
                                        args.fixtures))
        cfg.input_names = ("questions",)
        cfg.output_names = ("pred_acoustic_features",)
        trainer.init(hparams, model_config=cfg)
    else:
        trainer.init(hparams)


def stage4_acoustic(args, ids):
    trainer, hparams = _acoustic_trainer(args, ids)
    _log_resume_state(hparams, "stage 4 (acoustic)")
    _init_acoustic(args, trainer, hparams)
    val_loss, train_loss = trainer.train(hparams)
    logger.info("acoustic model trained")
    return {"val_loss": val_loss, "train_loss": train_loss}


def stage5_benchmark(args, ids):
    trainer, hparams = _acoustic_trainer(args, ids, strict_load=True)
    _init_acoustic(args, trainer, hparams)
    scores = trainer.benchmark(hparams, ids)
    logger.info("benchmark (MCD dB, F0-RMSE Hz, VDE, BAP dB): %s", scores)
    return scores


def stage6_synth(args, ids):
    from idiaptts_torch.ops.audio_io import get_raw
    trainer, hparams = _acoustic_trainer(args, ids, strict_load=True)
    _init_acoustic(args, trainer, hparams)
    hparams.synth_dir = os.path.join(args.work_dir, "synth")
    paths = trainer.synth(hparams, ids[:2])
    for path in paths.values():
        raw, _ = get_raw(path)
        logger.info("synthesised %s (rms %.4f)", path,
                    float(np.sqrt((raw ** 2).mean())))
    logger.info("NOTE: with few epochs on the fixture corpus the VUV head "
                "often predicts all-unvoiced, giving a very quiet "
                "waveform; copy-synthesis (trainer.copy_synth) is loud.")
    return paths


def stage7_serve(args, ids):
    """Submit every utterance concurrently to ``trainer.serve()``'s
    request-batching server; write the waveforms, report the server's
    statistics."""
    from idiaptts_torch.ops.audio_io import raw_to_file
    trainer, hparams = _acoustic_trainer(args, ids)
    _init_acoustic(args, trainer, hparams)
    server = trainer.serve(hparams, max_batch=8, max_wait_ms=20.0)
    _, _, load_inputs = trainer.build_serving(hparams)
    futures = [(i, server.submit(load_inputs(i))) for i in ids]
    out_dir = os.path.join(args.work_dir, "served")
    os.makedirs(out_dir, exist_ok=True)
    try:
        paths = {}
        for id_name, fut in futures:
            paths[id_name] = raw_to_file(
                os.path.join(out_dir, id_name + ".wav"),
                fut.result(timeout=600), hparams.get("synth_fs", 16000))
        stats = server.stats()
    finally:
        server.shutdown()
    logger.info("served %d requests in %d batches (occupancy %.1f, "
                "%.0fx realtime)", stats["requests"], stats["batches"],
                stats["mean_batch_occupancy"], stats["x_realtime"])
    return {"stats": stats, "paths": paths}


def stage8_wavenet(args, ids):
    """WaveNet vocoder: train on (WORLD features, waveform) pairs, export
    it for vocoding, neural-vocode one utterance."""
    from idiaptts_torch.models.wavenet import WaveNetWrapper
    from idiaptts_torch.ops.audio_io import get_raw
    from idiaptts_torch.train.wavenet_trainer import WaveNetVocoderTrainer

    hparams = WaveNetVocoderTrainer.create_hparams()
    hparams.out_dir = os.path.join(args.work_dir, "wavenet")
    hparams.model_name = "wavenet_voc"
    hparams.epochs = args.epochs
    hparams.batch_size_train = 2
    hparams.learning_rate = 1e-3
    hparams.seed = 1
    hparams.test_set_perc = 0.0
    hparams.val_set_perc = 0.25
    hparams.use_best_as_final_model = False
    hparams.max_input_train_sec = 0.4
    hparams.num_coded_sps_cond = NUM_SPS
    hparams.num_coded_sps = NUM_SPS
    hparams.load_newest_checkpoint = True
    hparams.device = args.device
    hparams.synth_dir = os.path.join(args.work_dir, "wavenet_synth")
    trainer = WaveNetVocoderTrainer(
        hparams, ids,
        dir_world_features=os.path.join(args.work_dir, "WORLD"),
        dir_audio=os.path.join(args.fixtures, "database", "wav"))
    _log_resume_state(hparams, "stage 8 (wavenet)")
    if args.small_models:
        # Conditioning: NUM_SPS mcep, lf0, vuv and one bap a frame.
        cfg = WaveNetWrapper.Config(
            input_names=("cond_features",), output_names=("pred_logits",),
            target_name="target_quantised", out_channels=256,
            residual_channels=16, gate_channels=32, skip_channels=16,
            num_layers=4, num_stacks=2, cond_channels=NUM_SPS + 3)
        trainer.init(hparams, model_config=cfg)
    else:
        trainer.init(hparams)
    val_loss, train_loss = trainer.train(hparams)
    bundle = trainer.save_for_vocoding(
        hparams, os.path.join(args.work_dir, "wavenet_bundle",
                              "wavenet_voc"))
    logger.info("vocoder bundle exported to %s", bundle)
    paths = trainer.synth(hparams, ids[:1])
    for path in paths.values():
        raw, _ = get_raw(path)
        logger.info("neural-vocoded %s (rms %.4f)", path,
                    float(np.sqrt((raw ** 2).mean())))
    return {"val_loss": val_loss, "train_loss": train_loss,
            "bundle": bundle, "paths": paths}


STAGES = {1: stage1_world, 2: stage2_labels, 3: stage3_duration,
          4: stage4_acoustic, 5: stage5_benchmark, 6: stage6_synth,
          7: stage7_serve, 8: stage8_wavenet}


def main(argv=None):
    """Run the stages ``--stage`` to ``--stop_stage``; returns {stage:
    its result}."""
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    recipe_common.add_common_arguments(parser, stop_stage=7, epochs=8)
    parser.add_argument("--small_models", action="store_true",
                        help="narrow architectures for CPU runs")
    args = parser.parse_args(argv)
    os.makedirs(args.work_dir, exist_ok=True)
    return recipe_common.run_stages(STAGES, args,
                                    recipe_common.read_ids(args.fixtures))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    main()
