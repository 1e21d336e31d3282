"""Corpus-prep throughput: epoch detection and feature analysis on bulk audio.

    python -m snickery_tpu_torch.bench_corpus_prep [--minutes 60] [--python-minutes 2]
                                                   [--utt-sec 6] [--device cuda|cpu]

Counterpart of ``scripts/bench_corpus_prep.py``: ``--minutes`` of
speech-like utterances (``synthetic_voices.synth_utterance``) of
``--utt-sec`` each go through the native epoch detector (one scalar call an
utterance, one thread), the first ``--python-minutes`` of them through the
Python detector, and all of them through ``magphase_analysis`` and
``world_analysis`` on ``--device`` (one call an utterance; the first call
starts the device).  Prints one line a stage: seconds and x-realtime.
Exits 1 where the native library cannot be built or loaded.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="snickery_tpu_torch.bench_corpus_prep")
    ap.add_argument("--minutes", type=float, default=60.0,
                    help="audio minutes for the native detector + analysis")
    ap.add_argument("--python-minutes", type=float, default=2.0,
                    help="audio minutes for the python detector (slow)")
    ap.add_argument("--utt-sec", type=float, default=6.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the analysis on the card) or cpu")
    args = ap.parse_args(argv)

    from snickery_tpu_torch import native, utils
    from snickery_tpu_torch.features.epochs import detect_epochs
    from snickery_tpu_torch.features.magphase import magphase_analysis
    from snickery_tpu_torch.features.world import world_analysis
    from snickery_tpu_torch.synthetic_voices import SR, synth_utterance

    utils.torch_device(args.device)
    if native.get_lib() is None:
        # detect_epochs would time the Python detector under the native label
        utils.logger.error("the native epoch library did not build or load")
        return 1
    n_utts = int(args.minutes * 60 / args.utt_sec)
    n_seg = max(2, int(args.utt_sec / 0.15))
    print(f"# generating {args.minutes:.0f} min of synthetic speech "
          f"({n_utts} utts x {args.utt_sec:.0f}s)", file=sys.stderr)
    waves = [synth_utterance(1000 + i, n_segments=n_seg)[0] for i in range(n_utts)]
    audio_sec = sum(len(w) for w in waves) / SR

    t0 = time.perf_counter()
    epochs = [detect_epochs(w, SR, use_native=True) for w in waves]
    t_native = time.perf_counter() - t0
    print(f"native epoch detector: {audio_sec:.0f}s audio in {t_native:.1f}s "
          f"({audio_sec / t_native:.0f}x realtime; 1 thread)")

    n_py = max(1, int(args.python_minutes * 60 / args.utt_sec))
    py_audio = sum(len(w) for w in waves[:n_py]) / SR
    t0 = time.perf_counter()
    for w in waves[:n_py]:
        detect_epochs(w, SR, use_native=False)
    t_py = time.perf_counter() - t0
    print(f"python epoch detector: {py_audio:.0f}s audio in {t_py:.1f}s "
          f"({py_audio / t_py:.0f}x realtime; native speedup "
          f"{(py_audio / t_py and (audio_sec / t_native) / (py_audio / t_py)):.1f}x)")

    t0 = time.perf_counter()
    for w, e in zip(waves, epochs):
        magphase_analysis(w, e, SR, device=args.device)
    t_mp = time.perf_counter() - t0
    print(f"magphase analysis: {audio_sec:.0f}s audio in {t_mp:.1f}s "
          f"({audio_sec / t_mp:.0f}x realtime)")

    t0 = time.perf_counter()
    for w, e in zip(waves, epochs):
        world_analysis(w, e, SR, device=args.device)
    t_w = time.perf_counter() - t0
    print(f"world analysis (mgc/bap): {audio_sec:.0f}s audio in {t_w:.1f}s "
          f"({audio_sec / t_w:.0f}x realtime)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
