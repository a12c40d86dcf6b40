"""Data types: discrete character alphabets with ambiguity semantics.

Role of dr.evolution.datatype.DataType (ref: src/dr/evolution/datatype/
DataType.java, Nucleotides.java, AminoAcids.java, TwoStates.java,
GeneralDataType.java) as a plain host-side value object; own copy of
beast_mcmc_tpu/data/datatype.py (numpy only). A
DataType maps characters to integer state codes and each state code to a
boolean "state set" over the canonical states (IUPAC ambiguity semantics).

All device-side code sees only dense arrays derived from these tables:
  - tip state codes  int32[taxa, sites]
  - the ambiguity table  f[num_codes, state_count]  (the per-code partial
    likelihood row: 1.0 where the code is compatible with the state)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataType:
    name: str
    state_count: int
    # char (upper-case) -> state code
    char_map: Dict[str, int]
    # state code -> tuple of canonical states it may be
    state_sets: Tuple[Tuple[int, ...], ...]
    code_chars: Tuple[str, ...]  # canonical char for each code (for export)

    @property
    def num_codes(self) -> int:
        return len(self.state_sets)

    @property
    def unknown_code(self) -> int:
        """The fully-ambiguous code (all canonical states allowed)."""
        full = tuple(range(self.state_count))
        for code, ss in enumerate(self.state_sets):
            if ss == full and code >= self.state_count:
                return code
        raise ValueError(f"{self.name} has no fully-ambiguous code")

    def encode(self, seq: str) -> np.ndarray:
        """Character string -> int16 state codes (unknown for unmapped). An
        ASCII string goes through a 128-entry lookup table at once (a
        Makona-size document holds 30 million characters)."""
        unknown = self.unknown_code
        seq = seq.upper()
        cm = self.char_map
        if seq.isascii():
            lut = np.full(128, unknown, dtype=np.int16)
            for ch, code in cm.items():
                if len(ch) == 1 and ch.isascii():
                    lut[ord(ch)] = code
            return lut[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]
        out = np.empty(len(seq), dtype=np.int16)
        for i, ch in enumerate(seq):
            out[i] = cm.get(ch, unknown)
        return out

    def decode(self, states: Sequence[int]) -> str:
        return "".join(self.code_chars[int(s)] for s in states)

    def ambiguity_table(self, dtype=np.float64) -> np.ndarray:
        """[num_codes, state_count] partial-likelihood rows per code."""
        tab = np.zeros((self.num_codes, self.state_count), dtype=dtype)
        for code, ss in enumerate(self.state_sets):
            tab[code, list(ss)] = 1.0
        return tab

    def state_set_mask(self, code: int) -> np.ndarray:
        m = np.zeros(self.state_count, dtype=bool)
        m[list(self.state_sets[code])] = True
        return m

    def is_ambiguous(self, code: int) -> bool:
        return len(self.state_sets[code]) != 1


def _make_nucleotides() -> DataType:
    # Canonical states: A=0, C=1, G=2, T=3 (ref: Nucleotides.java state order).
    iupac = {
        "A": (0,), "C": (1,), "G": (2,), "T": (3,), "U": (3,),
        "R": (0, 2), "Y": (1, 3), "M": (0, 1), "W": (0, 3),
        "S": (1, 2), "K": (2, 3),
        "B": (1, 2, 3), "D": (0, 2, 3), "H": (0, 1, 3), "V": (0, 1, 2),
        "N": (0, 1, 2, 3), "?": (0, 1, 2, 3), "-": (0, 1, 2, 3),
    }
    order = ["A", "C", "G", "T", "U", "R", "Y", "M", "W", "S", "K",
             "B", "D", "H", "V", "N", "?", "-"]
    # U aliases T's code; keep codes unique per char position in `order`
    # but map U -> code of T.
    code_chars = []
    state_sets = []
    char_map: Dict[str, int] = {}
    for ch in order:
        if ch == "U":
            char_map["U"] = char_map["T"]
            continue
        char_map[ch] = len(state_sets)
        state_sets.append(iupac[ch])
        code_chars.append(ch)
    return DataType(
        name="nucleotide",
        state_count=4,
        char_map=char_map,
        state_sets=tuple(state_sets),
        code_chars=tuple(code_chars),
    )


def _make_amino_acids() -> DataType:
    # Canonical order (ref: AminoAcids.java): ACDEFGHIKLMNPQRSTVWY
    canon = "ACDEFGHIKLMNPQRSTVWY"
    state_sets = [(i,) for i in range(20)]
    code_chars = list(canon)
    char_map = {ch: i for i, ch in enumerate(canon)}
    full = tuple(range(20))

    def add(ch, ss):
        char_map[ch] = len(state_sets)
        state_sets.append(ss)
        code_chars.append(ch)

    add("B", (canon.index("D"), canon.index("N")))
    add("Z", (canon.index("E"), canon.index("Q")))
    add("J", (canon.index("I"), canon.index("L")))
    add("X", full)
    add("*", full)
    add("?", full)
    add("-", full)
    return DataType(
        name="amino acid",
        state_count=20,
        char_map=char_map,
        state_sets=tuple(state_sets),
        code_chars=tuple(code_chars),
    )


def _make_binary() -> DataType:
    state_sets = [(0,), (1,), (0, 1), (0, 1)]
    return DataType(
        name="binary",
        state_count=2,
        char_map={"0": 0, "1": 1, "?": 2, "-": 3},
        state_sets=tuple(state_sets),
        code_chars=("0", "1", "?", "-"),
    )


def general_datatype(states: Sequence[str], ambiguities: Dict[str, Sequence[str]] | None = None) -> DataType:
    """A general K-state data type from user-supplied state labels.

    Role of GeneralDataType.java (discrete traits / phylogeography demes).
    """
    states = list(states)
    k = len(states)
    char_map = {s.upper(): i for i, s in enumerate(states)}
    state_sets = [(i,) for i in range(k)]
    code_chars = list(states)
    full = tuple(range(k))

    def add(ch, ss):
        char_map[ch.upper()] = len(state_sets)
        state_sets.append(tuple(ss))
        code_chars.append(ch)

    if ambiguities:
        for ch, subset in ambiguities.items():
            add(ch, tuple(char_map[s.upper()] for s in subset))
    for ch in ("?", "-"):
        if ch not in char_map:
            add(ch, full)
    return DataType(
        name=f"general{k}",
        state_count=k,
        char_map=char_map,
        state_sets=tuple(state_sets),
        code_chars=tuple(code_chars),
    )


NUCLEOTIDES = _make_nucleotides()
AMINO_ACIDS = _make_amino_acids()
BINARY = _make_binary()
