"""Batch feature extraction: a directory of wavs -> the tree ``train`` reads.

    python -m snickery_tpu_torch.extract -w WAVDIR -o OUTDIR \\
        [--streams mag,real,imag,lf0,mgc,bap] [-m DIM_MAG] [-p DIM_PHASE] \\
        [--dim-mgc N] [--dim-bap N] [--fixed-frameshift 0.005] \\
        [-s SAMPLE_RATE] [-N MAX_FILES] [--device cuda|cpu]

Counterpart of ``scripts/extract_magphase_features.py`` with the same flags,
defaults, exit codes and log lines, and ``--device`` added (``cuda`` by
default, raising where CUDA is absent; ``cpu`` runs the same analysis on
the host).  For every wav it writes the pitchmarks of the native epoch
detector to ``OUTDIR/pm/<base>.pm`` (EST) and each stream to
``OUTDIR/<stream>/<base>.<stream>`` (headerless float32), from the magphase
analysis (mag / real / imag / lf0) and the WORLD-style one (mgc / bap), the
analysis on ``device``.  ``--fixed-frameshift SEC`` also writes each stream
resampled to that frame rate under ``OUTDIR/fixed/<stream>/``.  Point a
voice config's ``pm_datadir`` at ``OUTDIR/pm`` and its ``feat_datadir`` at
``OUTDIR``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from snickery_tpu_torch import utils
from snickery_tpu_torch.features.epochs import detect_epochs
from snickery_tpu_torch.features.magphase import magphase_analysis
from snickery_tpu_torch.features.world import resample_to_fixed, world_analysis
from snickery_tpu_torch.io.est import write_est_pitchmarks
from snickery_tpu_torch.io.speech import put_speech, read_wave

logger = utils.logger

MAGPHASE = ("mag", "real", "imag")
WORLD = ("mgc", "bap")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="snickery_tpu_torch.extract")
    ap.add_argument("-w", "--wavdir", required=True)
    ap.add_argument("-o", "--outdir", required=True)
    ap.add_argument("--streams", default="mag,real,imag,lf0",
                    help="comma list from {mag,real,imag,lf0,mgc,bap}")
    ap.add_argument("-m", "--dim-mag", type=int, default=60)
    ap.add_argument("-p", "--dim-phase", type=int, default=45)
    ap.add_argument("--dim-mgc", type=int, default=60)
    ap.add_argument("--dim-bap", type=int, default=5)
    ap.add_argument("--fixed-frameshift", type=float, default=0.0,
                    help="also write fixed-rate stream variants at this "
                         "frame shift in seconds (e.g. 0.005); 0 = off")
    ap.add_argument("-s", "--sample-rate", type=int, default=0,
                    help="expected sample rate (0 = accept whatever the wavs are)")
    ap.add_argument("-N", "--max-files", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the analysis on the card) or cpu")
    args = ap.parse_args(argv)

    want = [s.strip() for s in args.streams.split(",") if s.strip()]
    bad = [s for s in want if s not in MAGPHASE + WORLD + ("lf0",)]
    if bad:
        logger.error("unknown streams: %s", bad)
        return 1

    bases = utils.basenames_in(args.wavdir, "wav")
    if args.max_files:
        bases = bases[: args.max_files]
    if not bases:
        logger.error("no wav files in %s", args.wavdir)
        return 1
    utils.torch_device(args.device)

    pm_dir = utils.safe_makedir(os.path.join(args.outdir, "pm"))
    stream_dirs = {s: utils.safe_makedir(os.path.join(args.outdir, s)) for s in want}
    fixed_dirs = {}
    if args.fixed_frameshift > 0:
        fixed_dirs = {s: utils.safe_makedir(os.path.join(args.outdir, "fixed", s))
                      for s in want}

    for i, base in enumerate(bases):
        wave, sr = read_wave(os.path.join(args.wavdir, base + ".wav"))
        if args.sample_rate and sr != args.sample_rate:
            logger.warning("%s: sample rate %d != %d, skipping", base, sr, args.sample_rate)
            continue
        epochs = detect_epochs(wave, sr)
        write_est_pitchmarks(epochs, os.path.join(pm_dir, base + ".pm"), sr)
        streams: dict[str, np.ndarray] = {}
        if any(s in MAGPHASE for s in want) or "lf0" in want:
            streams.update(magphase_analysis(wave, epochs, sr, n_mag=args.dim_mag,
                                             n_phase=args.dim_phase, device=args.device))
        if any(s in WORLD for s in want):
            w = world_analysis(wave, epochs, sr, n_mgc=args.dim_mgc, n_bap=args.dim_bap,
                               device=args.device)
            streams.update({k: v for k, v in w.items() if k not in streams})
        for s in want:
            put_speech(streams[s], os.path.join(stream_dirs[s], f"{base}.{s}"))
        for s, d in fixed_dirs.items():
            put_speech(resample_to_fixed(streams[s], epochs, sr,
                                         frameshift=args.fixed_frameshift),
                       os.path.join(d, f"{base}.{s}"))
        logger.info("[%d/%d] %s: %d epochs", i + 1, len(bases), base, len(epochs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
