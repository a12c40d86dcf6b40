"""Codon data type and genetic codes.

Role of dr.evolution.datatype.Codons + GeneticCode (ref:
src/dr/evolution/datatype/Codons.java, GeneticCode.java): 64 triplets
minus the code's stop codons, in lexicographic A,C,G,T order of the 61
sense codons (universal code), with the mapping to amino acids for the
dN/dS classification. Own copy of beast_mcmc_tpu/data/codons.py (numpy only).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from beast_mcmc_tpu_torch.data.datatype import DataType

NUC = "ACGT"

# Universal (standard) genetic code, codon -> one-letter AA, '*' = stop
UNIVERSAL_CODE: Dict[str, str] = {}
_TABLE = """
TTT F  TTC F  TTA L  TTG L
CTT L  CTC L  CTA L  CTG L
ATT I  ATC I  ATA I  ATG M
GTT V  GTC V  GTA V  GTG V
TCT S  TCC S  TCA S  TCG S
CCT P  CCC P  CCA P  CCG P
ACT T  ACC T  ACA T  ACG T
GCT A  GCC A  GCA A  GCG A
TAT Y  TAC Y  TAA *  TAG *
CAT H  CAC H  CAA Q  CAG Q
AAT N  AAC N  AAA K  AAG K
GAT D  GAC D  GAA E  GAG E
TGT C  TGC C  TGA *  TGG W
CGT R  CGC R  CGA R  CGG R
AGT S  AGC S  AGA R  AGG R
GGT G  GGC G  GGA G  GGG G
"""
_tokens = _TABLE.split()
for i in range(0, len(_tokens), 2):
    UNIVERSAL_CODE[_tokens[i]] = _tokens[i + 1]


def sense_codons(code: Dict[str, str] = UNIVERSAL_CODE) -> List[str]:
    """The 61 (universal) non-stop codons in lexicographic ACGT order."""
    out = []
    for a in NUC:
        for b in NUC:
            for c in NUC:
                cod = a + b + c
                if code[cod] != "*":
                    out.append(cod)
    return out


def codon_datatype(code: Dict[str, str] = UNIVERSAL_CODE) -> DataType:
    codons = sense_codons(code)
    k = len(codons)
    char_map = {c: i for i, c in enumerate(codons)}
    state_sets = [(i,) for i in range(k)]
    code_chars = list(codons)
    full = tuple(range(k))
    for ch in ("???", "---"):
        char_map[ch] = len(state_sets)
        state_sets.append(full)
        code_chars.append(ch)
    return DataType(
        name="codon",
        state_count=k,
        char_map=char_map,
        state_sets=tuple(state_sets),
        code_chars=tuple(code_chars),
    )


def encode_codon_alignment(states_nuc: np.ndarray,
                           code: Dict[str, str] = UNIVERSAL_CODE) -> np.ndarray:
    """Nucleotide state matrix [taxa, 3L] -> codon states [taxa, L].

    Triplets containing any ambiguity/gap (state > 3) or a stop codon map
    to the fully-ambiguous codon state (= state_count).
    """
    codons = sense_codons(code)
    cmap = {c: i for i, c in enumerate(codons)}
    n_taxa, n_sites = states_nuc.shape
    if n_sites % 3:
        raise ValueError("alignment length not a multiple of 3")
    out = np.full((n_taxa, n_sites // 3), len(codons), np.int16)
    for t in range(n_taxa):
        for j in range(0, n_sites, 3):
            tri = states_nuc[t, j:j + 3]
            if (tri > 3).any():
                continue
            cod = NUC[tri[0]] + NUC[tri[1]] + NUC[tri[2]]
            out[t, j // 3] = cmap.get(cod, len(codons))
    return out


def codon_structure(code: Dict[str, str] = UNIVERSAL_CODE
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pairwise classification over sense codons for GY94-style models.

    Returns (single[61,61], is_transition[61,61], is_nonsynonymous[61,61]):
    single marks pairs that differ at exactly one position; the other two
    are zero elsewhere (no multi-hit rates).
    """
    codons = sense_codons(code)
    k = len(codons)
    is_ts = np.zeros((k, k))
    is_nonsyn = np.zeros((k, k))
    single = np.zeros((k, k))
    transitions = {("A", "G"), ("G", "A"), ("C", "T"), ("T", "C")}
    for i in range(k):
        for j in range(k):
            if i == j:
                continue
            diffs = [(a, b) for a, b in zip(codons[i], codons[j]) if a != b]
            if len(diffs) != 1:
                continue
            single[i, j] = 1.0
            if diffs[0] in transitions:
                is_ts[i, j] = 1.0
            if code[codons[i]] != code[codons[j]]:
                is_nonsyn[i, j] = 1.0
    return single, is_ts, is_nonsyn
