"""Voice building: the ``train`` entry point of the port.

Counterpart of ``snickery_tpu/train.py``: enumerate the corpus (wav dir,
intersected with the pitchmark and label dirs), prepare each utterance's
epoch-aligned features (read from stream files, or computed by the port's
analysis on ``device`` when no feature dir holds them), cut units and write
the VoiceDB (the same ``.voicedb`` format as the JAX package's).
"""

from __future__ import annotations

import os

import numpy as np

from snickery_tpu_torch import utils
from snickery_tpu_torch.config import SnickeryConfig
from snickery_tpu_torch.io.est import read_est_pitchmarks
from snickery_tpu_torch.io.labels import halfphone_segments, read_hts_label
from snickery_tpu_torch.io.speech import get_speech, read_wave
from snickery_tpu_torch.voicedb.build import UtteranceData, build_voicedb
from snickery_tpu_torch.voicedb.db import VoiceDB

logger = utils.logger


def _load_streams(cfg: SnickeryConfig, base: str, n_epochs: int) -> np.ndarray | None:
    """Load per-stream epoch-rate feature files for one utterance -> (E, d)."""
    mats = []
    for stream in cfg.stream_list:
        p = os.path.join(cfg.feat_datadir, stream, f"{base}.{stream}")
        if not os.path.exists(p):
            return None
        mats.append(get_speech(p, cfg.datadims[stream]))
    n = min(n_epochs, *(len(m) for m in mats))
    return np.concatenate([m[:n] for m in mats], axis=1)


def _native_features(cfg: SnickeryConfig, wave: np.ndarray, epochs: np.ndarray,
                     device="cuda") -> np.ndarray:
    """Compute the configured streams on ``device``: magphase (mag / real /
    imag), WORLD-style (mgc / bap, with mfcc an alias of mgc) and lf0."""
    from snickery_tpu_torch.features.magphase import magphase_analysis
    from snickery_tpu_torch.features.world import world_analysis

    streams: dict[str, np.ndarray] = {}
    if any(s in ("mag", "real", "imag") for s in cfg.stream_list):
        n_mag = cfg.datadims.get("mag", 60)
        n_phase = cfg.datadims.get("real", cfg.datadims.get("imag", 45))
        streams.update(magphase_analysis(wave, epochs, cfg.sample_rate,
                                         n_mag=n_mag, n_phase=n_phase, device=device))
    if any(s in ("mgc", "bap", "mfcc") for s in cfg.stream_list):
        n_mgc = cfg.datadims.get("mgc", cfg.datadims.get("mfcc", 60))
        n_bap = cfg.datadims.get("bap", 5)
        w = world_analysis(wave, epochs, cfg.sample_rate, n_mgc=n_mgc, n_bap=n_bap,
                           device=device)
        w["mfcc"] = w["mgc"]
        streams.update({k: v for k, v in w.items() if k not in streams})
    if "lf0" in cfg.stream_list and "lf0" not in streams:
        from snickery_tpu_torch.features.epochs import f0_from_epochs
        streams["lf0"] = f0_from_epochs(epochs, cfg.sample_rate)
    mats = []
    for s in cfg.stream_list:
        if s not in streams:
            raise ValueError(f"cannot compute stream {s!r} natively")
        m = streams[s]
        if m.shape[1] != cfg.datadims[s]:
            raise ValueError(f"stream {s}: native dim {m.shape[1]} != configured {cfg.datadims[s]}")
        mats.append(m)
    return np.concatenate(mats, axis=1).astype(np.float32)


def _voiced_epoch_range(wave: np.ndarray, epochs: np.ndarray,
                        threshold_db: float = -35.0) -> slice:
    """Slice of epochs outside leading/trailing silence.

    Per-epoch RMS over a +/-64 sample window, thresholded relative to the
    utterance's 95th-percentile epoch level.
    """
    half = 64
    n = len(wave)
    idx = np.clip(epochs[:, None] + np.arange(-half, half)[None, :], 0, n - 1)
    rms = np.sqrt((wave[idx].astype(np.float64) ** 2).mean(axis=1) + 1e-12)
    ref = np.percentile(rms, 95)
    active = rms > ref * (10.0 ** (threshold_db / 20.0))
    if not active.any():
        return slice(0, 0)
    first = int(np.argmax(active))
    last = len(active) - int(np.argmax(active[::-1]))
    return slice(first, last)


def prepare_utterance(cfg: SnickeryConfig, base: str, device="cuda") -> UtteranceData | None:
    """Read one utterance's wave, epochs and features (and its labels in
    halfphone mode); features not read from files are analysed on
    ``device``."""
    from snickery_tpu_torch.features.epochs import detect_epochs, f0_from_epochs

    wav_path = os.path.join(cfg.wav_datadir, base + ".wav")
    if not os.path.exists(wav_path):
        return None
    wave, sr = read_wave(wav_path)
    if sr != cfg.sample_rate:
        raise ValueError(f"{base}: wav sample rate {sr} != config {cfg.sample_rate}")

    if cfg.target_representation == "sample":
        # sample-level units: a uniform fixed-hop frame grid replaces the
        # pitch-synchronous epochs (no pitchmarks needed)
        epochs = np.arange(cfg.sample_hop, len(wave) - 1, cfg.sample_hop,
                           dtype=np.int32)
    else:
        pm_path = os.path.join(cfg.pm_datadir, base + ".pm") if cfg.pm_datadir else ""
        if pm_path and os.path.exists(pm_path):
            epochs = read_est_pitchmarks(pm_path, sr)
        else:
            epochs = detect_epochs(wave, sr)
    epochs = epochs[(epochs >= 0) & (epochs < len(wave))]
    if len(epochs) < 4:
        logger.warning("%s: only %d epochs, skipping", base, len(epochs))
        return None

    feats = None
    if cfg.feat_datadir:
        feats = _load_streams(cfg, base, len(epochs))
    if feats is None:
        feats = _native_features(cfg, wave, epochs, device)
    n = min(len(feats), len(epochs))
    feats, epochs = feats[:n], epochs[:n]

    if cfg.trim_silence and cfg.target_representation != "halfphone":
        # epoch-mode silence trimming: drop leading/trailing epochs whose
        # local energy is far below the utterance peak (features are sliced
        # with the same range; halfphone mode trims by label instead, below)
        keep = _voiced_epoch_range(wave, epochs)
        epochs, feats = epochs[keep], feats[keep]
        if len(epochs) < 4:
            logger.warning("%s: silence trimming left %d epochs, skipping",
                           base, len(epochs))
            return None

    lf0 = f0_from_epochs(epochs, sr).reshape(-1)

    halfphones = None
    if cfg.target_representation == "halfphone":
        lab_path = os.path.join(cfg.lab_datadir, base + ".lab")
        if not os.path.exists(lab_path):
            logger.warning("%s: no label file, skipping", base)
            return None
        phones = read_hts_label(lab_path)
        if cfg.trim_silence:
            while phones and phones[0].phone in cfg.silence_symbols:
                phones = phones[1:]
            while phones and phones[-1].phone in cfg.silence_symbols:
                phones = phones[:-1]
        halfphones = halfphone_segments(phones)

    return UtteranceData(base, wave, epochs.astype(np.int32), feats, lf0, halfphones)


def corpus_basenames(cfg: SnickeryConfig) -> list[str]:
    bases = utils.basenames_in(cfg.wav_datadir, "wav")
    if cfg.pm_datadir and os.path.isdir(cfg.pm_datadir):
        pm = set(utils.basenames_in(cfg.pm_datadir, "pm"))
        if pm:
            bases = [b for b in bases if b in pm]
    if cfg.target_representation == "halfphone":
        lab = set(utils.basenames_in(cfg.lab_datadir, "lab"))
        bases = [b for b in bases if b in lab]
    if cfg.n_train_utts:
        bases = bases[: cfg.n_train_utts]
    return bases


def train_voice(cfg: SnickeryConfig, save: bool = True, device="cuda") -> VoiceDB:
    """Build the voice database for ``cfg`` (the analysis on ``device``) and
    optionally save it; the stages (prepare_utterance, build_voicedb, save)
    are timed and logged as "train <stage> <seconds>s (n=<count>)"."""
    utils.torch_device(device)
    bases = corpus_basenames(cfg)
    if not bases:
        raise FileNotFoundError(f"no training utterances under {cfg.wav_datadir}")
    logger.info("building voice %r from %d utterances (device %s)", cfg.voice_name,
                len(bases), device)
    utts = []
    timer = utils.StageTimer()
    for base in bases:
        with timer.stage("prepare_utterance"):
            utt = prepare_utterance(cfg, base, device)
        if utt is not None:
            utts.append(utt)
    with timer.stage("build_voicedb"):
        db = build_voicedb(cfg, utts)
    if save:
        with timer.stage("save"):
            utils.safe_makedir(cfg.workdir)
            db.save(cfg.db_path)
        logger.info("saved %s", cfg.db_path)
    timer.log("train")
    return db
