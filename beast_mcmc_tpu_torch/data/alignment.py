"""Alignments and site-pattern compression.

Role of dr.evolution.alignment.SimpleAlignment / SitePatterns (ref:
src/dr/evolution/alignment/SitePatterns.java:50-58 — unique patterns with
weights) as numpy preprocessing that emits the dense arrays the likelihood
kernels consume. Own copy of beast_mcmc_tpu/data/alignment.py (numpy only;
the pattern compression is numpy's, in first-occurrence order):

  pattern_states : int32[taxa, patterns]   tip state codes per unique column
  pattern_weights: f[patterns]             multiplicity of each column

Site-pattern compression is the reference's long-sequence scaling axis:
logL = sum_p weight_p * logL_p, independent over p.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from beast_mcmc_tpu_torch.data.datatype import DataType, NUCLEOTIDES


@dataclasses.dataclass
class Alignment:
    """An immutable multiple sequence alignment (host-side)."""

    taxa: List[str]
    states: np.ndarray  # int16[taxa, sites] state codes
    datatype: DataType
    # optional per-taxon sampling dates (height = age before youngest tip)
    dates: Optional[Dict[str, float]] = None

    @classmethod
    def from_sequences(
        cls,
        taxa: Sequence[str],
        sequences: Sequence[str],
        datatype: DataType = NUCLEOTIDES,
        dates: Optional[Dict[str, float]] = None,
    ) -> "Alignment":
        if len(taxa) != len(sequences):
            raise ValueError("taxa/sequences length mismatch")
        lens = {len(s) for s in sequences}
        if len(lens) != 1:
            # pad short sequences with gaps to the longest (ref:
            # SimpleAlignment.java:304-313 — getState past a sequence's
            # length returns the gap state)
            width = max(lens)
            sequences = [s + "-" * (width - len(s)) for s in sequences]
        states = np.stack([datatype.encode(s) for s in sequences])
        return cls(list(taxa), states, datatype, dates)

    @property
    def n_taxa(self) -> int:
        return self.states.shape[0]

    @property
    def n_sites(self) -> int:
        return self.states.shape[1]

    def taxon_index(self, name: str) -> int:
        return self.taxa.index(name)

    def tip_heights(self) -> np.ndarray:
        """Tip heights (age before the youngest sample) from dates.

        Dates are forward-time (larger = more recent); heights run backward
        from the youngest tip, as in dr.evolution.util.Date usage.
        """
        if not self.dates:
            return np.zeros(self.n_taxa)
        latest = max(self.dates.values())
        return np.array([latest - self.dates.get(t, latest) for t in self.taxa])


@dataclasses.dataclass
class SitePatterns:
    """Unique site patterns with weights (ref: SitePatterns.java:50-58)."""

    taxa: List[str]
    states: np.ndarray  # int16[taxa, patterns]
    weights: np.ndarray  # float64[patterns]
    datatype: DataType
    n_sites: int

    @classmethod
    def from_alignment(
        cls,
        alignment: Alignment,
        site_range: Optional[Tuple[int, int]] = None,
        every: int = 1,
    ) -> "SitePatterns":
        """Compress columns to unique patterns.

        site_range=(from, to) and `every` mirror the codon-position
        sub-pattern selection of SitePatterns(alignment, taxa, from, to,
        every) used for partitioned codon-position models.
        """
        cols = alignment.states
        if site_range is not None:
            lo, hi = site_range
            hi = alignment.n_sites if hi < 0 else hi + 1
            cols = cols[:, lo:hi]
        if every > 1:
            cols = cols[:, ::every]
        n_sites = cols.shape[1]
        # first-occurrence pattern order, like the reference's SitePatterns
        uniq, first, counts = np.unique(cols, axis=1, return_index=True,
                                        return_counts=True)
        by_first = np.argsort(first, kind="stable")
        uniq, counts = uniq[:, by_first], counts[by_first]
        return cls(
            taxa=list(alignment.taxa),
            states=uniq.astype(np.int16),
            weights=counts.astype(np.float64),
            datatype=alignment.datatype,
            n_sites=n_sites,
        )

    @classmethod
    def from_attribute(cls, taxa: Sequence[str], values: Sequence[str],
                       datatype: DataType) -> "SitePatterns":
        """One-column patterns from a taxon attribute, one value a taxon,
        over a general data type of named states: the discrete-trait data
        of <attributePatterns> (AttributePatternsParser;
        beast_mcmc_tpu/config/xml_geo.py:89). An unknown value is the
        fully ambiguous code."""
        states = np.array([[datatype.char_map.get(v.strip().upper(),
                                                  datatype.unknown_code)]
                           for v in values], np.int16)
        return cls(taxa=list(taxa), states=states, weights=np.ones(1),
                   datatype=datatype, n_sites=1)

    @property
    def n_taxa(self) -> int:
        return self.states.shape[0]

    @property
    def n_patterns(self) -> int:
        return self.states.shape[1]

    def empirical_frequencies(self) -> np.ndarray:
        """PAUP-style EM estimate of state frequencies.

        Matches PatternList.Utils.empiricalStateFrequenciesPAUP (ref:
        src/dr/evolution/alignment/PatternList.java): iterate
        freq_j <- sum over characters of freq_j / (sum of freqs in the
        character's state set), weighted, until convergence. Ambiguity
        codes share their weight across compatible states in proportion to
        the current frequency estimate.
        """
        k = self.datatype.state_count
        table = self.datatype.ambiguity_table()  # [codes, k]
        # per pattern/taxon state-set rows, flattened with weights
        rows = table[self.states]  # [taxa, patterns, k]
        w = np.broadcast_to(self.weights, self.states.shape).astype(np.float64)
        rows = rows.reshape(-1, k)
        w = w.reshape(-1)
        freqs = np.full(k, 1.0 / k)
        for _ in range(1000):
            contrib = rows * freqs  # [chars, k]
            denom = contrib.sum(axis=1, keepdims=True)
            # all-zero rows impossible: every code maps to >=1 state
            share = contrib / denom * w[:, None]
            new = share.sum(axis=0)
            new /= new.sum()
            diff = np.abs(new - freqs).sum()
            freqs = new
            if diff <= 1e-8:
                break
        return freqs

    def tip_partials(self, dtype=np.float64) -> np.ndarray:
        """[taxa, patterns, state_count] partial-likelihood rows
        (ambiguity-aware tip partials; ref BeagleDataLikelihoodDelegate
        setPartials path when useAmbiguities=true)."""
        return self.datatype.ambiguity_table(dtype)[self.states]

    def tip_states_unambiguous(self) -> np.ndarray:
        """[taxa, patterns] int32 where any ambiguous code (partial or
        full) is mapped to state_count = "missing" (ref: the tip-states
        path when useAmbiguities=false; BEAGLE treats codes >= stateCount
        as all-ones)."""
        out = self.states.astype(np.int32).copy()
        for code in range(self.datatype.num_codes):
            if self.datatype.is_ambiguous(code):
                out[self.states == code] = self.datatype.state_count
        return out
