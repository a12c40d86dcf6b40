"""Sequence file importers (role of dr.evolution.io.*Importer).

FASTA (ref: src/dr/evolution/io/FastaImporter.java) and a pragmatic NEXUS
subset (ref: NexusImporter.java): DATA/CHARACTERS matrix and TREES block,
which covers the reference's example/test corpora.

The port's own copy of beast_mcmc_tpu/data/io.py: host-side numpy over this
package's modules, the same outputs on the same inputs and seeds.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from beast_mcmc_tpu_torch.data.alignment import Alignment
from beast_mcmc_tpu_torch.data.datatype import AMINO_ACIDS, NUCLEOTIDES, DataType


def read_fasta(text: str, datatype: DataType = NUCLEOTIDES) -> Alignment:
    taxa: List[str] = []
    seqs: List[str] = []
    cur: List[str] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if taxa:
                seqs.append("".join(cur))
            taxa.append(line[1:].split()[0])
            cur = []
        else:
            cur.append(line)
    if taxa:
        seqs.append("".join(cur))
    return Alignment.from_sequences(taxa, seqs, datatype)


def write_fasta(alignment: Alignment) -> str:
    lines = []
    for i, t in enumerate(alignment.taxa):
        lines.append(f">{t}")
        lines.append(alignment.datatype.decode(alignment.states[i]))
    return "\n".join(lines) + "\n"


_NEXUS_DT = {"DNA": NUCLEOTIDES, "RNA": NUCLEOTIDES, "NUCLEOTIDE": NUCLEOTIDES,
             "PROTEIN": AMINO_ACIDS}


def read_nexus(text: str) -> Tuple[Optional[Alignment], Dict[str, str]]:
    """Parse a NEXUS file. Returns (alignment|None, {tree_name: newick}).

    Handles DATA/CHARACTERS blocks (FORMAT DATATYPE=..., MATRIX) and TREES
    blocks with TRANSLATE tables.
    """
    # strip comments
    text = re.sub(r"\[[^\]]*\]", "", text)
    body = re.sub(r"^\s*#NEXUS", "", text, flags=re.I)
    blocks = re.findall(r"BEGIN\s+(\w+)\s*;(.*?)END\s*;", body, re.S | re.I)
    alignment = None
    trees: Dict[str, str] = {}
    for name, content in blocks:
        name = name.upper()
        if name in ("DATA", "CHARACTERS"):
            alignment = _parse_matrix_block(content)
        elif name == "TREES":
            trees.update(_parse_trees_block(content))
    return alignment, trees


def _parse_matrix_block(content: str) -> Alignment:
    """DATA/CHARACTERS block with the FORMAT vocabulary of
    NexusImporter.java: DATATYPE, GAP=, MISSING=, MATCHCHAR=,
    INTERLEAVE, quoted taxon names; validates against NTAX/NCHAR when
    declared (ref: src/dr/evolution/io/NexusImporter.java readDataBlock/
    readCharactersBlock)."""
    dt = NUCLEOTIDES
    fmt = re.search(r"FORMAT([^;]*);", content, re.S | re.I)
    gap_char = missing_char = match_char = None
    if fmt is not None:
        f = fmt.group(1)
        m = re.search(r"DATATYPE\s*=\s*(\w+)", f, re.I)
        if m:
            key = m.group(1).upper()
            if key not in _NEXUS_DT:
                raise ValueError(f"unsupported NEXUS DATATYPE {key!r}")
            dt = _NEXUS_DT[key]
        m = re.search(r"GAP\s*=\s*(\S)", f, re.I)
        gap_char = m.group(1) if m else None
        m = re.search(r"MISSING\s*=\s*(\S)", f, re.I)
        missing_char = m.group(1) if m else None
        m = re.search(r"MATCHCHAR\s*=\s*(\S)", f, re.I)
        match_char = m.group(1) if m else None
    dims = re.search(r"DIMENSIONS([^;]*);", content, re.S | re.I)
    ntax = nchar = None
    if dims is not None:
        m = re.search(r"NTAX\s*=\s*(\d+)", dims.group(1), re.I)
        ntax = int(m.group(1)) if m else None
        m = re.search(r"NCHAR\s*=\s*(\d+)", dims.group(1), re.I)
        nchar = int(m.group(1)) if m else None

    mm = re.search(r"MATRIX(.*?);", content, re.S | re.I)
    if not mm:
        raise ValueError("NEXUS DATA block without MATRIX")
    taxa: List[str] = []
    seqs: Dict[str, List[str]] = {}
    # quoted names may contain spaces; token = 'quoted' | "quoted" | bare
    row_re = re.compile(
        r"""^\s*(?:'([^']+)'|"([^"]+)"|(\S+))\s+(.+)$"""
    )
    for line in mm.group(1).splitlines():
        line = line.strip()
        if not line:
            continue
        m = row_re.match(line)
        if not m:
            continue
        name = (m.group(1) or m.group(2) or m.group(3)).replace(" ", "_")
        seq = re.sub(r"\s", "", m.group(4))
        if name not in seqs:
            taxa.append(name)
            seqs[name] = []
        seqs[name].append(seq)  # interleaved blocks concatenate
    out = []
    first = "".join(seqs[taxa[0]]) if taxa else ""
    for t in taxa:
        s = "".join(seqs[t])
        # normalize declared gap/missing/matchchar into the datatype's
        # own codes ('-' and '?')
        if gap_char and gap_char not in "-":
            s = s.replace(gap_char, "-").replace(gap_char.lower(), "-")
        if missing_char and missing_char not in "?":
            s = s.replace(missing_char, "?").replace(missing_char.lower(), "?")
        if match_char:
            s = "".join(
                first[i] if c in (match_char, match_char.lower()) else c
                for i, c in enumerate(s)
            )
        out.append(s)
    if ntax is not None and len(taxa) != ntax:
        raise ValueError(f"NEXUS NTAX={ntax} but matrix has {len(taxa)} taxa")
    if nchar is not None and out and len(out[0]) != nchar:
        raise ValueError(
            f"NEXUS NCHAR={nchar} but sequences have {len(out[0])} sites"
        )
    return Alignment.from_sequences(taxa, out, dt)


def _parse_trees_block(content: str) -> Dict[str, str]:
    translate: Dict[str, str] = {}
    tm = re.search(r"TRANSLATE(.*?);", content, re.S | re.I)
    if tm:
        for entry in tm.group(1).split(","):
            m = re.match(
                r"""\s*(\S+)\s+(?:'([^']+)'|"([^"]+)"|(\S+))""", entry
            )
            if m:
                name = (m.group(2) or m.group(3) or m.group(4)).strip("'\",")
                translate[m.group(1)] = name.replace(" ", "_")
    trees: Dict[str, str] = {}
    for m in re.finditer(r"TREE\s+\*?\s*(\S+)\s*=\s*(?:\[&[A-Za-z]\])?\s*([^;]+);",
                         content, re.I):
        name, newick = m.group(1), m.group(2).strip() + ";"
        if translate:
            newick = re.sub(
                r"(?<=[(,])\s*([^\s(),:\[\]]+)",
                lambda mm: translate.get(mm.group(1), mm.group(1)),
                newick,
            )
        trees[name] = newick
    return trees
