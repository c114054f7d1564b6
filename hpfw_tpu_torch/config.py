"""HpfwConfig — every behavioral knob of the hashprint pipeline in one place.

A copy of hpfw_tpu/config.py: importing anything under hpfw_tpu imports jax,
and the GPU port must run where jax is absent. The copy keeps the same
fields, defaults and JSON form, so a database's config_json round-trips
between the two packages; tests/test_torch_config.py pins it to the original.

The reference (kisasexypantera94/hpfw) bakes its parameters in as C++
template/constructor arguments (SURVEY.md §3.5, §5 "Config/flag system");
the reference mount was empty at build time (SURVEY.md §0) so defaults here
follow the hashprint literature (Tsai et al., "Known-Artist Live Song ID
Using Audio Hashprints"): 22.05 kHz audio, CQT with 24 bins/octave over
C3..C8, ~23 ms hop, 20-frame spectro-temporal context, 64 learned filters,
sign-of-delta binarization.

The config is serialized into every fingerprint database (SURVEY.md §5) so a
DB is self-describing: extraction and matching can never disagree on
parameters.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass

# C3 in Hz (A4 = 440).
_C3_HZ = 130.8127826502993


@dataclass(frozen=True)
class HpfwConfig:
    """All ⚙ knobs of SURVEY.md §2.3, pinned.

    Every field participates in the bit-exactness contract: two runs with the
    same config and same input PCM must produce identical packed hashprints.
    """

    # ---- input ----
    sample_rate: int = 22050
    resample: str = "sinc"        # ingestion resampler: "sinc" (polyphase
                                  # Kaiser, reference-grade) or "linear"
                                  # (fast, aliases above ~sr/4)

    # ---- CQT front end (SURVEY.md §2.3 step 2) ----
    fmin: float = _C3_HZ          # lowest CQT bin center
    bins_per_octave: int = 24
    n_bins: int = 121             # C3..C8 inclusive at 24 bins/octave
    hop: int = 512                # ~23.2 ms @ 22050 Hz -> ~43 frames/s
    frame_len: int = 8192         # pow2 >= longest CQT kernel (~5753 samples)
    window: str = "hann"          # per-bin kernel window
    log_eps: float = 1e-4         # spec = log(log_eps + |X|)

    # ---- hashprint stage (SURVEY.md §2.3 steps 3-7) ----
    context_w: int = 20           # consecutive CQT frames per context window
    delta_lag: int = 16           # T: bit_i(n) = [y_i(n) - y_i(n+T) > 0]
    n_filters: int = 64           # learned spectro-temporal projections
    bit_order: str = "lsb0"       # filter i -> bit i of the 64-bit word
    tie_break: str = "gt"         # strict '>' at delta == 0 (bit is 0 on tie)

    # ---- matcher / database ----
    db_downsample: int = 16       # coarse-stage temporal downsample factor
    coarse_kind: str = "sign"     # coarse print statistic per bit-window:
                                  # majority "sign" or raw "sum". sign wins
                                  # the 10k-track recall study at every
                                  # stride x pool point (the sum's magnitude
                                  # variance pollutes ranking) — RESULTS.md
    top_k: int = 10               # ranked candidates returned by match()
    fine_candidates: int = 256    # coarse->fine rescan pool size
    coarse_query_phases: int = 1  # coarse query phase variants scanned and
                                  # max-combined per track (must divide
                                  # db_downsample): the query's vote windows
                                  # are anchored to its own first print, so
                                  # a misphased true offset collapses the
                                  # coarse peak (-24 points of top-1 at
                                  # r~stride/2 on the 250k real catalog,
                                  # benchmarks/phase_diag.py); >1 trades
                                  # coarse MACs for phase robustness
    coarse_prefilter: int = 0     # two-pass phased coarse: pass-1 scans the
                                  # whole catalog with coarse_prefilter_phases
                                  # variant lanes and pools the top
                                  # `coarse_prefilter` tracks per query; the
                                  # full phase grid then rescans only those
                                  # gathered rows (block-diagonal Pallas
                                  # kernel). 0 = single-pass. The one-pass
                                  # phased scan is MXU-bound ~1 ms/variant
                                  # lane per 250k tracks — at phases=8 the
                                  # prefilter cuts phased coarse cost ~3x
                                  # (RESULTS.md round 3)
    coarse_prefilter_phases: int = 1  # pass-1 phase variants (must divide
                                      # db_downsample)
    coarse_prefilter_channels: int = 0  # pass-1 coarse channels (<= coarse_
                                        # channels; 0 = same). The pass-1
                                        # catalog sweep is HBM-bound on the
                                        # flat coarse DB, and hashprint
                                        # channels are PCA-ordered — a
                                        # C1<C prefix subset halves/quarters
                                        # pass-1 bytes (extra HBM: C1/64 of
                                        # the coarse DB) while pass 2 still
                                        # rescans its pooled rows at full C
    coarse_prefilter_pack4: bool = False  # nibble-pack the pass-1 rows (two
                                          # ±1 values per byte, unpacked in
                                          # registers): halves pass-1 HBM
                                          # bytes again, bit-identical
                                          # ranking; Pallas path only
                                          # (ops/pallas_coarse, round 5)
    coarse_channels: int = 64     # coarse-print channels per window (<=64):
                                  # hashprint channels are PCA-ordered, so
                                  # the first C are the most informative —
                                  # C<64 shrinks coarse bytes by C/64
                                  # (recall cost: benchmarks/channel_study)
    stretch_span: float = 0.0     # query-side tempo-scan half-width: >0
                                  # matches each query at hypothesized tempo
                                  # factors 1±span (print-level time gather,
                                  # match/stretch.py) and keeps the best —
                                  # rigid-alignment scoring collapses at
                                  # >=1% tempo error over a 10 s query
                                  # (RESULTS round 4 robustness), so live-ID
                                  # deployments want 0.03; costs ~V=
                                  # 2*span/step+1 dispatches per query
    stretch_step: float = 0.01    # tempo-hypothesis grid spacing (residual
                                  # <= step/2 after the scan; the rigid
                                  # aligner absorbs <=0.5% — stretch_study)
    pitch_span_bins: int = 0      # query-side pitch-scan half-width in CQT
                                  # bins: >0 additionally matches each
                                  # query re-keyed by bin rolls -p..+p
                                  # (one bin = 0.5 st at 24 bins/octave;
                                  # spec-level re-key before context
                                  # assembly, match/stretch.py pitch_grid).
                                  # Composes with the tempo grid as a
                                  # product: V = (2p+1) * (2*span/step+1)
                                  # hypothesis rows per query

    # ---- derived ----
    @property
    def q_factor(self) -> float:
        return 1.0 / (2.0 ** (1.0 / self.bins_per_octave) - 1.0)

    @property
    def context_dim(self) -> int:
        """Dimensionality of one spectro-temporal context vector."""
        return self.n_bins * self.context_w

    @property
    def frames_per_second(self) -> float:
        return self.sample_rate / self.hop

    def bin_frequency(self, k: int) -> float:
        return self.fmin * 2.0 ** (k / self.bins_per_octave)

    def n_frames(self, n_samples: int) -> int:
        """CQT frames for a PCM buffer of n_samples (no padding, full frames)."""
        if n_samples < self.frame_len:
            return 0
        return 1 + (n_samples - self.frame_len) // self.hop

    def n_hashprints(self, n_samples: int) -> int:
        """Hashprints emitted for a PCM buffer of n_samples."""
        f = self.n_frames(n_samples)
        return max(0, f - self.context_w + 1 - self.delta_lag)

    def min_samples(self) -> int:
        """Smallest PCM length that yields one hashprint."""
        need_frames = self.context_w + self.delta_lag
        return self.frame_len + (need_frames - 1) * self.hop

    # ---- (de)serialization ----
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "HpfwConfig":
        return cls(**json.loads(s))

    @classmethod
    def catalog_scale(cls, **overrides) -> "HpfwConfig":
        """The measured catalog-scale operating point (100k+ tracks).

        The plain defaults run a single-pass, single-phase coarse stage —
        right for small catalogs and for the CPU/XLA paths, but at 250k
        real-audio tracks query/DB coarse-window misphase costs ~20 points
        of top-1 (RESULTS.md round 3). This preset pins the measured
        recall point: phase-scanned coarse querying with the two-pass
        prefilter (cheap channel-subset pass 1 over the whole catalog,
        full-channel phased rescan of the pooled rows) — measured 0.865
        top-1 = 95% of the 0.91 dense ceiling at 250k real-audio tracks,
        8.8 ms/query single / 4.4 ms batched on one v5e (RESULTS.md round
        3). Requires the Pallas (TPU) match path; small catalogs lose
        nothing beyond a little compute.
        """
        kw = dict(fine_candidates=1024, coarse_query_phases=8,
                  coarse_prefilter=8192, coarse_prefilter_phases=2,
                  coarse_prefilter_channels=32)
        kw.update(overrides)
        return cls(**kw)

    def validate(self) -> None:
        assert self.n_filters == 64, "hashprints are 64-bit words"
        assert self.bit_order in ("lsb0", "msb0")
        assert self.tie_break in ("gt", "ge")
        assert self.coarse_kind in ("sign", "sum")
        assert (8 <= self.coarse_channels <= 64
                and self.coarse_channels % 8 == 0), \
            "coarse_channels must be a multiple of 8 in [8, 64]"
        assert self.coarse_prefilter >= 0
        if self.coarse_prefilter:
            assert self.db_downsample % self.coarse_prefilter_phases == 0, \
                "coarse_prefilter_phases must divide db_downsample"
        c1 = self.coarse_prefilter_channels
        assert c1 == 0 or (8 <= c1 <= self.coarse_channels and c1 % 8 == 0), \
            ("coarse_prefilter_channels must be 0 (= coarse_channels) or a "
             "multiple of 8 in [8, coarse_channels]")
        if self.coarse_kind == "sum":
            assert self.db_downsample <= 127, "sum coarse prints are int8"
        assert 0.0 <= self.stretch_span < 0.2, \
            "stretch_span is a tempo fraction (0 disables; >=20% is not a " \
            "rendition of the same performance)"
        assert self.stretch_step > 0.0
        if self.stretch_span:
            assert self.stretch_span >= self.stretch_step, \
                "stretch_span must be at least one grid step"
        assert 0 <= self.pitch_span_bins <= self.bins_per_octave // 4, \
            ("pitch_span_bins is a CQT bin-roll half-width (0 disables; "
             "more than ±1.5 st is not the same performance's key range)")
        assert self.window in ("hann", "hamming")
        max_kernel = int(-(-self.q_factor * self.sample_rate // self.fmin))
        assert self.frame_len >= max_kernel, (
            f"frame_len {self.frame_len} < longest CQT kernel {max_kernel}"
        )


DEFAULT_CONFIG = HpfwConfig()
