"""Speed-perturbation data augmentation (the classic Kaldi 3-way recipe).

A copy of :mod:`tfkaldi_tpu.frontend.perturb` (numpy and scipy only). The
reference has no data augmentation at all; this implements the
standard ``sp0.9 / 1.0 / 1.1`` corpus expansion (the semantics of Kaldi's
``utils/data/perturb_data_dir_speed.sh`` + sox ``speed f``) directly at
feature-preparation time: each utterance's raw signal is resampled by
factor ``f`` (duration scales by ``1/f``), features are computed on the
resampled signal through the same batched device extractor (kernel 2
frames them on the card), and the
featdir's ``utt2spk``/``spk2utt``/``text`` metadata are expanded with
``sp{f}-``-prefixed utterance and speaker ids. Factor ``1.0`` keeps the
original ids, so unperturbed keys keep matching any externally produced
artifacts (alignments, segments) exactly.

Because the expansion happens on the *featdir* side and the GMM stages
run over the featdir, Kaldi alignment of the perturbed corpus produces
alignments under the same prefixed keys — the hybrid CE path trains on
the 3-way data with no further plumbing. The text-target losses
(CTC/RNN-T/attention) only need the expanded ``text``, written here.

Enable with ``speed_perturb = 0.9,1.0,1.1`` in a features config section.
"""

from __future__ import annotations

import numpy as np


def parse_factors(spec: str) -> tuple[float, ...]:
    """Parse a ``speed_perturb`` config value ("0.9,1.0,1.1") into factors.

    Duplicates are rejected (two copies of the same factor would collide
    on utterance ids); factors must be positive.
    """
    factors: list[float] = []
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        f = float(tok)
        if f <= 0:
            raise ValueError(f"speed_perturb factor must be > 0, got {tok!r}")
        # dedup on the id-prefix string, not just numerically: two factors
        # that differ by >1e-12 but render to the same %g prefix (0.9 vs
        # 0.8999999) would collide on utterance ids / ark keys
        if any(
            abs(f - g) < 1e-12 or factor_prefix(f) == factor_prefix(g)
            for g in factors
        ):
            raise ValueError(f"duplicate speed_perturb factor {tok!r}")
        factors.append(f)
    if not factors:
        raise ValueError(f"speed_perturb spec has no factors: {spec!r}")
    return tuple(factors)


def factor_prefix(factor: float) -> str:
    """Kaldi-convention utterance/speaker id prefix: ``sp0.9-``; empty for 1.0."""
    if factor == 1.0:
        return ""
    return f"sp{factor:g}-"


def _rational(factor: float) -> tuple[int, int]:
    """``1/factor`` as ``(up, down)``; sp factors are short decimals
    (9/10, 11/10) so the rational form is exact for the standard recipe."""
    from fractions import Fraction

    frac = Fraction(factor).limit_denominator(1000)
    return frac.denominator, frac.numerator


_FILTER_CACHE: dict[tuple[int, int], np.ndarray] = {}


def _antialias_filter(up: int, down: int) -> np.ndarray:
    """Long Kaiser-windowed lowpass at the polyphase rate.

    scipy's default (``kaiser`` beta 5.0, half-length ``10*max(up,down)``)
    leaves only ~-18 dB near the band edge; sox's ``speed`` is far
    sharper. 32 taps/phase with beta 12 gives ~-50 dB within 4% of the
    cutoff and a flat passband — measured in tests/test_speed_perturb.py.
    """
    key = (up, down)
    h = _FILTER_CACHE.get(key)
    if h is None:
        from scipy.signal import firwin

        max_ud = max(up, down)
        half = 32 * max_ud
        h = firwin(2 * half + 1, 1.0 / max_ud, window=("kaiser", 12.0))
        _FILTER_CACHE[key] = h
    return h


def resample_signal(sig: np.ndarray, factor: float) -> np.ndarray:
    """Resample a 1-D signal by speed ``factor`` (sox ``speed`` semantics).

    Band-limited polyphase resampling (``scipy.signal.resample_poly`` on
    a rational ``up/down`` approximation of ``1/factor``), matching sox
    ``speed``'s anti-aliased behavior: content above the new effective
    Nyquist is filtered out for ``factor > 1`` instead of aliasing, and
    high frequencies are preserved for ``factor < 1``. Output length is
    ``round(n / factor)`` so duration scales by ``1/factor``. Factor 1.0
    returns the input unchanged (bit-exact identity — the unperturbed
    copy of a 3-way corpus must be byte-identical to a run without
    perturbation).
    """
    if factor == 1.0:
        return sig
    n = len(sig)
    new_len = max(0, int(round(n / factor)))
    if n == 0 or new_len == 0:
        return sig[:0].astype(np.float32)
    from scipy.signal import resample_poly

    up, down = _rational(factor)
    # padtype='line': extend edges along the local linear trend so the
    # filter does not ring against implicit zero padding at utterance
    # boundaries
    out = resample_poly(
        sig.astype(np.float64), up, down,
        window=_antialias_filter(up, down), padtype="line",
    )
    # polyphase length is ceil(n*up/down); pin to round(n/factor) so the
    # duration contract (and downstream frame counts) are deterministic
    if len(out) >= new_len:
        out = out[:new_len]
    else:  # pragma: no cover - ceil >= round always, kept as a guard
        out = np.pad(out, (0, new_len - len(out)))
    return out.astype(np.float32)


def expand_metadata(datadir: str, featdir: str, factors: tuple[float, ...]) -> None:
    """Write ``utt2spk``/``spk2utt``/``text`` into ``featdir`` with one
    ``sp{f}-``-prefixed copy of every line per factor.

    Speaker ids are prefixed too (perturbed audio has shifted spectral
    statistics, so CMVN must not pool a speaker's perturbed and clean
    copies — the Kaldi convention). ``spk2utt`` is rebuilt from the
    expanded ``utt2spk`` rather than prefixed line-by-line.
    """
    import os

    u2s_path = os.path.join(datadir, "utt2spk")
    utt2spk: list[tuple[str, str]] = []
    if os.path.isfile(u2s_path):
        with open(u2s_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    utt2spk.append((parts[0], parts[1]))
        expanded = [
            (factor_prefix(f) + utt, factor_prefix(f) + spk)
            for f in factors
            for utt, spk in utt2spk
        ]
        with open(os.path.join(featdir, "utt2spk"), "w") as f:
            for utt, spk in expanded:
                f.write(f"{utt} {spk}\n")
        spk2utt: dict[str, list[str]] = {}
        for utt, spk in expanded:
            spk2utt.setdefault(spk, []).append(utt)
        with open(os.path.join(featdir, "spk2utt"), "w") as f:
            for spk, utts in spk2utt.items():
                f.write(f"{spk} {' '.join(utts)}\n")

    text_path = os.path.join(datadir, "text")
    if os.path.isfile(text_path):
        with open(text_path) as f:
            lines = [line.rstrip("\n") for line in f if line.strip()]
        with open(os.path.join(featdir, "text"), "w") as f:
            for fac in factors:
                pre = factor_prefix(fac)
                for line in lines:
                    utt, _, rest = line.partition(" ")
                    f.write(f"{pre}{utt} {rest}\n")
