"""Command-line interface of the port, on the card by default.

    python -m snickery_tpu_torch.cli train -c CONFIG [--device cuda|cpu]
    python -m snickery_tpu_torch.cli synth -c CONFIG [-o OUTDIR] [--greedy]
                                           [--voice V] [--dump-units] [--device cuda|cpu]
    python -m snickery_tpu_torch.cli evaluate -s SYNTH_DIR -r REF_DIR [-o REPORT] [-c CONFIG]
                                              [-N MAX] [--legacy-line] [--device cuda|cpu]
    python -m snickery_tpu_torch.cli merge A.voicedb B.voicedb -o M.voicedb [--names a,b]
    python -m snickery_tpu_torch.cli info  -c CONFIG
    python -m snickery_tpu_torch.cli serve -c CONFIG [--port 8300] [--device cuda|cpu]

The counterpart of ``snickery_tpu.cli`` with the same options and outputs:
one config file and one ``.voicedb`` directory serve both.  ``train`` builds
the voice (the analysis on ``--device``).  ``synth`` runs in hybrid
(DNN-target) mode when the config names a ``test_data_dir`` (stream files,
fixed-rate ones resampled onto an epoch grid when ``test_data_frameshift >
0``), else in natural mode (the wavs of ``wav_datadir`` analysed as the
trainer analyses them); in batches of ``synth_batch`` when that is above 1.
``evaluate`` prints the objective quality report as one strict-JSON
document.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from snickery_tpu_torch import utils
from snickery_tpu_torch.config import SnickeryConfig, load_config

logger = utils.logger


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-c", "--config", required=True, help="config file (.cfg/.py/.json)")


def _add_device(p: argparse.ArgumentParser, help: str) -> None:
    p.add_argument("--device", default="cuda", help=help)


def cmd_train(args: argparse.Namespace) -> int:
    from snickery_tpu_torch.train import train_voice

    cfg = load_config(args.config)
    db = train_voice(cfg, device=args.device)
    logger.info("voice built: %s", db.summary())
    return 0


def _test_basenames(cfg: SnickeryConfig) -> list[str]:
    """Test utterances: config patterns, else everything in test_data_dir's
    first stream subdir, else the training wav dir (copy-synthesis)."""
    if cfg.test_data_dir:
        stream0 = cfg.stream_list[0]
        bases = utils.basenames_in(os.path.join(cfg.test_data_dir, stream0), stream0)
    else:
        bases = utils.basenames_in(cfg.wav_datadir, "wav")
    if cfg.test_patterns:
        bases = [b for b in bases if any(pat in b for pat in cfg.test_patterns)]
    return bases


def _target_features_for(cfg: SnickeryConfig, base: str, device="cuda"):
    """Epoch-rate target trajectory of a test utterance: from its stream
    files under test_data_dir (predicted by an external DNN), or in natural
    mode from its wav, analysed on ``device`` as the trainer analyses it.
    Returns (features (E, d), lf0 (E,) or None, halfphone segments or None,
    epochs or None)."""
    from snickery_tpu_torch.io.speech import get_speech

    if not cfg.test_data_dir:
        from snickery_tpu_torch.train import prepare_utterance
        utt = prepare_utterance(cfg, base, device)
        if utt is None:
            raise FileNotFoundError(f"cannot prepare test utterance {base}")
        return utt.features, utt.lf0, utt.halfphones, utt.epochs
    mats = []
    for stream in cfg.stream_list:
        p = os.path.join(cfg.test_data_dir, stream, f"{base}.{stream}")
        if not os.path.exists(p):
            raise FileNotFoundError(p)
        mats.append(get_speech(p, cfg.datadims[stream]))
    n = min(len(m) for m in mats)
    feats = np.concatenate([m[:n] for m in mats], axis=1)
    lf0_col = None
    for (name, a, b) in cfg.stream_slices:
        if name == "lf0":
            lf0_col = a
    epochs = None
    if cfg.test_data_frameshift > 0:
        # fixed-rate DNN outputs: integrate the predicted lf0 into an epoch
        # grid and resample every stream onto it
        from snickery_tpu_torch.features.world import fixed_to_epoch_targets
        if lf0_col is None:
            raise ValueError(
                "test_data_frameshift > 0 needs an lf0 stream to "
                "integrate the epoch grid from")
        feats, epochs = fixed_to_epoch_targets(
            feats, lf0_col, cfg.sample_rate, frameshift=cfg.test_data_frameshift)
    lf0 = feats[:, lf0_col] if lf0_col is not None else None
    return feats, lf0, None, epochs


def cmd_synth(args: argparse.Namespace) -> int:
    from snickery_tpu_torch.io.speech import write_wave
    from snickery_tpu_torch.synth import Synthesiser

    cfg = load_config(args.config)
    if args.output_dir:
        cfg.output_dir = args.output_dir
    outdir = cfg.output_dir or os.path.join(cfg.workdir, "synth_output")
    utils.safe_makedir(outdir)

    synth = Synthesiser(cfg, device=args.device)
    bases = _test_basenames(cfg)
    if args.utterances:
        bases = [b for b in bases if b in set(args.utterances)]
    if not bases:
        logger.error("no test utterances found")
        return 1
    logger.info("synthesising %d utterances -> %s (device %s)", len(bases), outdir,
                args.device)
    halfphone = synth.db.target_representation == "halfphone"

    def emit(base, result):
        out_path = os.path.join(outdir, base + ".wav")
        write_wave(result["wave"], out_path, cfg.sample_rate)
        logger.info("%s: %d units, cost %.2f -> %s",
                    base, result["n_units"], result["total_cost"], out_path)
        if args.dump_units:
            np.save(os.path.join(outdir, base + ".units.npy"), result["unit_ids"])

    voice = args.voice if getattr(args, "voice", None) else None
    if synth.is_multivoice and voice is None:
        logger.error("multi-voice DB: pass --voice (available: %s)",
                     synth.db.voice_names)
        return 1

    use_batch = (cfg.synth_batch > 1 and not halfphone
                 and not (args.greedy or (args.greedy is None and cfg.greedy_search)))
    if use_batch:
        # batched path (config synth_batch > 1): one device step per group
        def flush(group, names):
            voices = [voice] * len(group) if synth.is_multivoice else None
            for b, r in zip(names, synth.synth_batch(group, voices=voices)):
                emit(b, r)

        group, names = [], []
        for base in bases:
            feats, _, _, _ = _target_features_for(cfg, base, args.device)
            group.append(feats)
            names.append(base)
            if len(group) == cfg.synth_batch:
                flush(group, names)
                group, names = [], []
        if group:
            flush(group, names)
    else:
        for base in bases:
            feats, _, segments, epochs = _target_features_for(cfg, base, args.device)
            if halfphone:
                if segments is None:
                    logger.warning("%s: no labels for halfphone targets, skipping", base)
                    continue
                tgt, kept = synth.halfphone_targets_from_features(feats, epochs, segments)
                result = synth.synth_from_features(tgt, greedy=args.greedy,
                                                   target_segments=kept, voice=voice)
            else:
                result = synth.synth_from_features(feats, greedy=args.greedy, voice=voice)
            emit(base, result)
    synth.timer.log("synth")
    return 0


def cmd_merge(args: argparse.Namespace) -> int:
    """Merge several voice DBs into one multi-voice DB (config #5 prep)."""
    from snickery_tpu_torch.voicedb.db import VoiceDB
    from snickery_tpu_torch.voicedb.multivoice import merge_voicedbs

    dbs = [VoiceDB.load(p) for p in args.voicedbs]
    names = args.names.split(",") if args.names else None
    if names and len(names) != len(dbs):
        logger.error("--names needs exactly %d entries", len(dbs))
        return 1
    merged = merge_voicedbs(dbs, names=names)
    merged.save(args.output)
    logger.info("merged %d voices -> %s (%s)", len(dbs), args.output,
                merged.summary())
    return 0


def cmd_info(args: argparse.Namespace) -> int:
    from snickery_tpu_torch.voicedb.db import VoiceDB

    cfg = load_config(args.config)
    if os.path.isdir(cfg.db_path):
        db = VoiceDB.load(cfg.db_path)
        print(db.summary())
    else:
        print(f"no voice DB at {cfg.db_path}")
    if args.device == "cuda":
        import torch
        print(f"device cuda: {torch.cuda.get_device_name(0)}"
              if torch.cuda.is_available() else "device cuda: not available")
    for key, val in sorted(cfg.to_dict().items()):
        print(f"  {key} = {val!r}")
    return 0


def cmd_evaluate(args: argparse.Namespace) -> int:
    """Objective quality report: synthesised wavs vs reference wavs, matched
    by basename: MCD (dB), NSIM, the prosody trio VDE / GPE / FFE and, when
    ``-c`` names the voice config and the synth dir holds ``<base>.units.npy``
    (``synth --dump-units``), the join-discontinuity flux ratio at
    non-natural joins; per utterance plus means, as one strict-JSON document
    (nan is written as null).  The spectra are computed on ``--device``."""
    import json

    from snickery_tpu_torch.evaluate import (f0_metrics, join_discontinuity,
                                             mel_cepstral_distortion, nsim)
    from snickery_tpu_torch.io.speech import read_wave

    utils.torch_device(args.device)
    db = taper = None
    if getattr(args, "config", ""):
        from snickery_tpu_torch.voicedb.db import VoiceDB
        cfg = load_config(args.config)
        db = VoiceDB.load(os.path.join(cfg.workdir, cfg.voice_name + ".voicedb"))
        taper = cfg.taper_length

    bases = sorted(b for b in utils.basenames_in(args.synth_dir, "wav")
                   if os.path.exists(os.path.join(args.ref_dir, b + ".wav")))
    if args.utterances:
        bases = [b for b in bases if b in set(args.utterances)]
    if args.max_files:
        bases = bases[: args.max_files]
    if not bases:
        logger.error("no basenames common to %s and %s", args.synth_dir, args.ref_dir)
        return 1
    dev = args.device
    rows = []
    for base in bases:
        s, sr_s = read_wave(os.path.join(args.synth_dir, base + ".wav"))
        r, sr_r = read_wave(os.path.join(args.ref_dir, base + ".wav"))
        if sr_s != sr_r:
            logger.warning("%s: sample-rate mismatch %d vs %d, skipping", base, sr_s, sr_r)
            continue
        row = {"utterance": base,
               "mcd_db": mel_cepstral_distortion(s, r, sr_s, device=dev),
               "nsim": nsim(s, r, sr_s, device=dev)}
        row.update(f0_metrics(s, r, sr_s, device=dev))
        flux_msg = ""
        units_path = os.path.join(args.synth_dir, base + ".units.npy")
        if db is not None and os.path.exists(units_path):
            # unit i starts at taper + the sum of the previous spans;
            # corpus-consecutive units reconstruct the corpus exactly, so only
            # non-natural joins can pop
            ids = np.load(units_path)
            cuts = db.cutpoints
            spans = (cuts[ids, 2] - cuts[ids, 1]).astype(np.int64)
            starts = taper + np.cumsum(spans) - spans
            nonnat = np.nonzero(cuts[ids[1:], 1] != cuts[ids[:-1], 2])[0] + 1
            flux = join_discontinuity(s, sr_s, starts[nonnat], device=dev)
            row["join_flux_ratio"] = flux["ratio"]
            row["n_nonnatural_joins"] = int(len(nonnat))
            flux_msg = f", join flux ratio {flux['ratio']:.2f} ({len(nonnat)} joins)"
        rows.append(row)
        logger.info("%s: MCD %.2f dB, NSIM %.3f, FFE %.3f%s",
                    base, row["mcd_db"], row["nsim"], row["ffe"], flux_msg)
    if not rows:
        logger.error("no comparable utterance pairs")
        return 1
    # the union over all rows: an utterance without units.npy has no flux
    keys = sorted({k for r in rows for k in r} - {"utterance", "n_nonnatural_joins"})
    means = {}
    for k in keys:
        vals = [r[k] for r in rows if k in r]
        # utterances with no non-natural join report nan flux: omit a mean
        # that no utterance could give
        if vals and np.isfinite(vals).any():
            means[k] = float(np.nanmean(vals))
    report = {"utterances": rows, "mean": means}
    # strict JSON: nan is not valid JSON, null is
    report = json.loads(json.dumps(report, default=float), parse_constant=lambda _: None)
    doc = json.dumps(report, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(doc + "\n")
        logger.info("report -> %s", args.output)
    print(doc)
    if getattr(args, "legacy_line", False):
        # one strict-JSON summary line last on stdout, for consumers of the
        # old evaluate_quality.py output
        print(json.dumps({"metric": "mcd_db", "value": means.get("mcd_db"),
                          "unit": "dB", "n_utterances": len(rows)}))
    return 0


def cmd_serve(args: argparse.Namespace) -> int:
    from snickery_tpu_torch.server import serve

    serve(args.config, host=args.host, port=args.port,
          max_batch=args.max_batch, max_wait_ms=args.max_wait_ms, device=args.device)
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="snickery_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    on_card = "cuda (the default: the hand-written kernels) or cpu (their plain twins)"

    p_train = sub.add_parser("train", help="build a voice database")
    _add_common(p_train)
    _add_device(p_train, "cuda (the default: the analysis on the card) or cpu")
    p_train.set_defaults(fn=cmd_train)

    p_synth = sub.add_parser("synth", help="synthesise test utterances")
    _add_common(p_synth)
    p_synth.add_argument("-o", "--output-dir", default="")
    p_synth.add_argument("--greedy", action=argparse.BooleanOptionalAction,
                         default=None,
                         help="force greedy online selection (--greedy) or "
                              "Viterbi (--no-greedy); default follows the "
                              "config's greedy_search")
    p_synth.add_argument("--dump-units", action="store_true",
                         help="also save selected unit ids per utterance")
    p_synth.add_argument("--voice", default="",
                         help="voice name/id to select from (multi-voice DBs)")
    _add_device(p_synth, on_card)
    p_synth.add_argument("utterances", nargs="*", help="restrict to these basenames")
    p_synth.set_defaults(fn=cmd_synth)

    p_merge = sub.add_parser("merge", help="merge voice DBs into a multi-voice DB")
    p_merge.add_argument("voicedbs", nargs="+", help="input .voicedb dirs")
    p_merge.add_argument("-o", "--output", required=True)
    p_merge.add_argument("--names", default="", help="comma list of voice names")
    _add_device(p_merge, "accepted as by the other commands; merging runs on the host")
    p_merge.set_defaults(fn=cmd_merge)

    p_info = sub.add_parser("info", help="show voice/config info")
    _add_common(p_info)
    _add_device(p_info, "cuda (the default: also report the card) or cpu")
    p_info.set_defaults(fn=cmd_info)

    p_eval = sub.add_parser(
        "evaluate", help="objective quality report (MCD/NSIM/FFE) for "
                         "synthesised wavs vs matching reference wavs")
    p_eval.add_argument("-s", "--synth-dir", required=True,
                        help="directory of synthesised .wav files")
    p_eval.add_argument("-r", "--ref-dir", required=True,
                        help="directory of reference .wav files (matched by basename)")
    p_eval.add_argument("-o", "--output", default="", help="also write the JSON report here")
    p_eval.add_argument("-c", "--config", default="",
                        help="voice config: enables join-discontinuity reporting when "
                             "the synth dir holds <base>.units.npy files "
                             "(synth --dump-units)")
    p_eval.add_argument("-N", "--max-files", type=int, default=0)
    p_eval.add_argument("--legacy-line", action="store_true",
                        help="also print the one-line JSON summary ({'metric': "
                             "'mcd_db', ...}) as the last stdout line")
    _add_device(p_eval, "cuda (the default: the spectra on the card) or cpu")
    p_eval.add_argument("utterances", nargs="*", help="restrict to these basenames")
    p_eval.set_defaults(fn=cmd_evaluate)

    p_serve = sub.add_parser(
        "serve", help="HTTP synthesis server with dynamic request batching")
    _add_common(p_serve)
    p_serve.add_argument("--host", default="0.0.0.0")
    p_serve.add_argument("--port", type=int, default=8300)
    p_serve.add_argument("--max-batch", type=int, default=32)
    p_serve.add_argument("--max-wait-ms", type=float, default=20.0)
    _add_device(p_serve, on_card)
    p_serve.set_defaults(fn=cmd_serve)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
