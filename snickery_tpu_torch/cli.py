"""Command-line interface of the port, on the card by default.

    python -m snickery_tpu_torch.cli synth -c CONFIG [-o OUTDIR] [--greedy]
                                           [--voice V] [--dump-units] [--device cuda|cpu]
    python -m snickery_tpu_torch.cli merge A.voicedb B.voicedb -o M.voicedb [--names a,b]
    python -m snickery_tpu_torch.cli info  -c CONFIG
    python -m snickery_tpu_torch.cli serve -c CONFIG [--port 8300] [--device cuda|cpu]

The counterpart of ``snickery_tpu.cli`` with the same options and outputs:
one config file and one ``.voicedb`` directory serve both.  ``synth`` runs in
hybrid (DNN-target) mode: stream files under ``test_data_dir``, fixed-rate
ones resampled onto an epoch grid when ``test_data_frameshift > 0``, in
batches of ``synth_batch`` when that is above 1.  Natural-mode synthesis
(no ``test_data_dir``: analysing test wavs), ``train`` and ``evaluate``
need the analysis chain and the voice builder, which are not ported yet:
they raise NotImplementedError (see ROADMAP.md queue 1 items 11 and 12).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from snickery_tpu_torch import utils
from snickery_tpu_torch.config import SnickeryConfig, load_config

logger = utils.logger
_TODO = ("not ported to snickery_tpu_torch yet: it needs the feature analysis "
         "chain and the voice builder (see ROADMAP.md queue 1 items 11 and 12)")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-c", "--config", required=True, help="config file (.cfg/.py/.json)")


def _add_device(p: argparse.ArgumentParser, help: str) -> None:
    p.add_argument("--device", default="cuda", help=help)


def cmd_train(args: argparse.Namespace) -> int:
    raise NotImplementedError(f"train: {_TODO}")


def cmd_evaluate(args: argparse.Namespace) -> int:
    raise NotImplementedError(f"evaluate: {_TODO}")


def _test_basenames(cfg: SnickeryConfig) -> list[str]:
    """Test utterances: the basenames in test_data_dir's first stream
    subdirectory, filtered by the config's test_patterns."""
    stream0 = cfg.stream_list[0]
    bases = utils.basenames_in(os.path.join(cfg.test_data_dir, stream0), stream0)
    if cfg.test_patterns:
        bases = [b for b in bases if any(pat in b for pat in cfg.test_patterns)]
    return bases


def _target_features_for(cfg: SnickeryConfig, base: str):
    """Epoch-rate target trajectory of a test utterance from its stream
    files under test_data_dir (predicted by an external DNN).  Returns
    (features (E, d), lf0 (E,) or None, halfphone segments (None: stream
    files carry no labels), epochs or None)."""
    from snickery_tpu_torch.io.speech import get_speech

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
    if not cfg.test_data_dir:
        raise NotImplementedError(
            f"natural-mode synth (no test_data_dir: analyse the test wavs): {_TODO}")
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
            feats, _, _, _ = _target_features_for(cfg, base)
            group.append(feats)
            names.append(base)
            if len(group) == cfg.synth_batch:
                flush(group, names)
                group, names = [], []
        if group:
            flush(group, names)
    else:
        for base in bases:
            feats, _, segments, _ = _target_features_for(cfg, base)
            if halfphone and segments is None:
                logger.warning("%s: no labels for halfphone targets, skipping", base)
                continue
            emit(base, synth.synth_from_features(feats, greedy=args.greedy, voice=voice))
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


def cmd_serve(args: argparse.Namespace) -> int:
    from snickery_tpu_torch.server import serve

    serve(args.config, host=args.host, port=args.port,
          max_batch=args.max_batch, max_wait_ms=args.max_wait_ms, device=args.device)
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="snickery_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    on_card = "cuda (the default: the hand-written kernels) or cpu (their plain twins)"

    p_train = sub.add_parser("train", help="build a voice database (not ported)")
    _add_common(p_train)
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

    p_eval = sub.add_parser("evaluate", help="objective quality report (not ported)")
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
