# Copy of veryfasttree_tpu/io/alignment.py (the port imports none of it).
"""Alignment reading: FASTA / FASTQ / PHYLIP-interleaved / NEXUS (+ gz/bz2/xz).

Re-implementation of the reference parser behaviors (ref src/Alignment.cpp:
15-481): format sniffing by first character, FASTA name truncation at
``(),: \\t`` (or ``'\\t`` with -quote), FASTQ quality-line skipping, PHYLIP
interleaved blocks with name checking, NEXUS data/characters + trees blocks
with translate tables, normalization of '.'->'-' and (nucleotide) 'U'->'T',
'N'->'X', and sequence-length validation.  Transparent decompression replaces
the reference's bxzstr layer (ref main.cpp:671).
"""
from __future__ import annotations

import bz2
import gzip
import io as _io
import lzma
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..constants import NOCODE


def open_maybe_compressed(path: str):
    with open(path, "rb") as f:
        magic = f.read(6)
    if magic[:2] == b"\x1f\x8b":
        return _io.TextIOWrapper(gzip.open(path, "rb"))
    if magic[:3] == b"BZh":
        return _io.TextIOWrapper(bz2.open(path, "rb"))
    if magic[:6] == b"\xfd7zXZ\x00":
        return _io.TextIOWrapper(lzma.open(path, "rb"))
    return open(path, "r")


@dataclass
class Alignment:
    names: List[str] = field(default_factory=list)
    seqs: List[str] = field(default_factory=list)
    n_pos: int = 0
    tree: str = ""  # NEXUS-embedded tree, if requested via -intree *name


def read_alignment(fp, options, log=None) -> Alignment:
    first = fp.readline()
    if not first:
        raise ValueError("Empty alignment input")
    line = first.rstrip("\n").rstrip("\r")
    if line.startswith("#NEXUS"):
        aln = _read_nexus(fp, options, log)
    elif line.startswith(">"):
        aln = _read_fasta(fp, line, options)
    elif line.startswith("@"):
        aln = _read_fastq(fp, line, options)
    else:
        aln = _read_phylip(fp, line, options)

    for i, s in enumerate(aln.seqs):
        if len(s) != aln.n_pos:
            raise ValueError(
                f"Wrong number of characters for {aln.names[i]}: expected {aln.n_pos} "
                f"but have {len(s)} instead.\nThis sequence may be truncated, or another "
                f"sequence may be too long.")

    # normalize: '.' -> '-'; nucleotide U->T, N->X (ref Alignment.cpp:453-473)
    found_dot = False
    out = []
    for s in aln.seqs:
        if "." in s:
            found_dot = True
            s = s.replace(".", "-")
        if options.n_codes == 4:
            s = s.replace("U", "T").replace("N", "X")
        out.append(s)
    aln.seqs = out
    if found_dot and log is not None:
        print('Warning! Found "." character(s). These are treated as gaps', file=log)
    return aln


def _name_stops(options):
    return "'\t" if options.quote else "(),: \t"


def _read_fasta(fp, first_line, options) -> Alignment:
    aln = Alignment()
    stops = _name_stops(options)
    cur: List[str] = []

    def flush_name(line):
        name = line[1:]
        for ch in stops:
            idx = name.find(ch)
            if idx >= 0:
                name = name[:idx]
        aln.names.append(name)

    flush_name(first_line)
    for raw in fp:
        line = raw.rstrip("\n").rstrip("\r")
        if not line:
            continue
        if line.startswith(">"):
            aln.seqs.append("".join(cur))
            cur = []
            flush_name(line)
        else:
            for ch in " \t":
                idx = line.find(ch)
                if idx >= 0:
                    line = line[:idx]
            cur.append(line)
    aln.seqs.append("".join(cur))
    if len(aln.names) != len(aln.seqs):
        raise ValueError(f"No sequence data for last entry {aln.names[-1]}")
    aln.n_pos = max(len(s) for s in aln.seqs)
    return aln


def _read_fastq(fp, first_line, options) -> Alignment:
    aln = Alignment()
    stops = _name_stops(options)
    line = first_line
    while line is not None:
        line = line.rstrip("\n").rstrip("\r")
        if not line.startswith("@"):
            raise ValueError("Malformed FASTQ record header: " + line)
        name = line[1:]
        for ch in stops:
            idx = name.find(ch)
            if idx >= 0:
                name = name[:idx]
        aln.names.append(name)
        seq_lines = []
        for raw in fp:
            s = raw.rstrip("\n").rstrip("\r")
            if s.startswith("+"):
                break
            seq_lines.append(s.split(" ")[0].split("\t")[0])
        seq = "".join(seq_lines)
        aln.seqs.append(seq)
        # skip quality characters (may span lines) -- same length as sequence
        qlen = 0
        line = None
        for raw in fp:
            s = raw.rstrip("\n").rstrip("\r")
            if qlen >= len(seq) and s.startswith("@"):
                line = raw
                break
            qlen += len(s)
    aln.n_pos = max(len(s) for s in aln.seqs)
    return aln


def _read_phylip(fp, header, options) -> Alignment:
    parts = header.split()
    if len(parts) < 2:
        raise ValueError("Error parsing phylip header line: " + header)
    n_seq, n_pos = int(parts[0]), int(parts[1])
    if n_seq < 1 or n_pos < 1:
        raise ValueError("Error parsing phylip header line: " + header)
    aln = Alignment(names=[""] * n_seq, seqs=[""] * n_seq, n_pos=n_pos)
    chunks = ["" for _ in range(n_seq)]
    i_seq = 0
    for raw in fp:
        line = raw.rstrip("\n").rstrip("\r")
        if not line and (i_seq == n_seq or i_seq == 0):
            i_seq = 0
            continue
        if not line:
            continue
        if line[0] == " ":
            if not aln.names[i_seq]:
                raise ValueError("No name in phylip line: " + line)
            j = 0
        else:
            j = line.find(" ")
            if j <= 0:
                raise ValueError("No sequence in phylip line: " + line)
            if i_seq >= n_seq:
                raise ValueError("No empty line between sequence blocks "
                                 "(is the sequence count wrong?)")
            if not aln.names[i_seq]:
                aln.names[i_seq] = line[:j]
        seq_part = line[j:].replace(" ", "").upper()
        if len(chunks[i_seq]) + len(seq_part) > n_pos:
            raise ValueError(f"Too many characters (expected {n_pos}) for sequence "
                             f"named {aln.names[i_seq]}")
        chunks[i_seq] += seq_part
        i_seq += 1
        if i_seq == n_seq and len(chunks[0]) == n_pos:
            break
    if i_seq not in (0, n_seq):
        raise ValueError(f"Wrong number of sequences: expected {n_seq}")
    aln.seqs = chunks
    return aln


def _read_nexus(fp, options, log=None) -> Alignment:
    aln = Alignment()
    ntax = nchar = -1
    interleave = False
    fgap, fmatch = "-", "."
    translate = {}

    def read_value(line, name):
        idx = line.find(name)
        if idx < 0:
            return None
        idx += len(name)
        rest = line[idx:].lstrip()
        if not rest.startswith("="):
            return None
        return rest[1:].lstrip()

    in_chars = False
    lines = iter(fp)
    for raw in lines:
        line = raw.rstrip("\n").rstrip("\r")
        low = line.lower()
        if low.lstrip().startswith("begin") and ("characters" in low or "data" in low):
            # characters block header lines until "matrix"
            for raw2 in lines:
                l2 = raw2.rstrip("\n").rstrip("\r")
                ll = l2.lower()
                if "dimensions" in ll:
                    v = read_value(ll, "nchar")
                    if v:
                        nchar = int("".join(c for c in v.split()[0] if c.isdigit()))
                    v = read_value(ll, "ntax")
                    if v:
                        ntax = int("".join(c for c in v.split()[0] if c.isdigit()))
                elif "format" in ll:
                    v = read_value(ll, "interleave")
                    if v:
                        interleave = v.startswith("y")
                    v = read_value(ll, "gap")
                    if v:
                        fgap = v[0]
                    v = read_value(ll, "matchchar")
                    if v:
                        fmatch = v[0]
                elif "matrix" in ll:
                    break
            # matrix rows
            seqi = 0
            for raw2 in lines:
                l2 = raw2.rstrip("\n").rstrip("\r")
                stripped = l2.strip()
                if stripped.startswith(";"):
                    break
                if not stripped:
                    if interleave:
                        seqi = 0
                    continue
                pos = len(l2) - len(l2.lstrip())
                if l2[pos] in "'\"":
                    quote = l2[pos]
                    pos += 1
                    end = l2.find(quote, pos)
                    if end < 0:
                        raise ValueError("Wrong sequence name format: " + l2)
                    name = l2[pos:end]
                    pos = end + 1
                else:
                    end = pos
                    while end < len(l2) and not l2[end].isspace():
                        end += 1
                    name = l2[pos:end]
                    pos = end
                if seqi == len(aln.seqs):
                    aln.names.append(name)
                    aln.seqs.append("")
                chars = []
                prev = aln.seqs[seqi - 1] if seqi > 0 else ""
                cur_len = len(aln.seqs[seqi])
                for ch in l2[pos:]:
                    if ch.isspace():
                        continue
                    if ch == fgap:
                        chars.append("-")
                    elif ch == fmatch and seqi > 0:
                        chars.append(prev[cur_len + len(chars)])
                    else:
                        chars.append(ch)
                aln.seqs[seqi] += "".join(chars)
                seqi += 1
            in_chars = True
        elif low.lstrip().startswith("begin") and "trees" in low:
            # trees block: translate table + optional named tree
            for raw2 in lines:
                l2 = raw2.rstrip("\n").rstrip("\r")
                ll = l2.lower()
                if "translate" in ll:
                    for raw3 in lines:
                        l3 = raw3.rstrip("\n").rstrip("\r")
                        if ";" in l3:
                            break
                        parts = l3.strip().rstrip(",").split(None, 1)
                        if len(parts) == 2:
                            translate[parts[0]] = parts[1].strip()
                elif "tree" in ll and options.intree_file.startswith("*") and not aln.tree:
                    eq = l2.find("=")
                    if eq < 0:
                        continue
                    name = l2[: eq].strip()
                    name = name.split()[-1] if name else ""
                    want = options.intree_file[1:]
                    if want and want != name:
                        continue
                    p0, p1 = l2.find("("), l2.rfind(")")
                    if p0 < 0 or p1 < 0:
                        continue
                    tree = l2[p0 : p1 + 1]
                    if translate:
                        for k, v in translate.items():
                            out, i = [], 0
                            while i < len(tree):
                                if tree.startswith(k, i) and i > 0:
                                    prev_c = tree[i - 1]
                                    nxt = tree[i + len(k)] if i + len(k) < len(tree) else ""
                                    if prev_c in "(,:)" and nxt in "(,:)":
                                        out.append(v)
                                        i += len(k)
                                        continue
                                out.append(tree[i])
                                i += 1
                            tree = "".join(out)
                    aln.tree = tree
                elif "end;" in ll:
                    break
    if not in_chars:
        raise ValueError("No characters block found")
    aln.n_pos = len(aln.seqs[0]) if aln.seqs else 0
    if ntax > 0 and len(aln.seqs) != ntax:
        raise ValueError(f"Wrong number of sequences: expected {ntax}")
    return aln


# ---------------------------------------------------------------------------


@dataclass
class Uniquify:
    """Dedup identical sequences (ref struct Uniquify, src/Alignment.cpp:494-526)."""

    unique_seq: List[str]
    unique_first: List[int]   # iUnique -> first index in alignment
    aln_next: List[int]       # alignment index -> next duplicate or -1
    aln_to_uniq: List[int]    # alignment index -> iUnique

    @classmethod
    def build(cls, aln: Alignment) -> "Uniquify":
        first_of = {}
        unique_seq, unique_first = [], []
        n = len(aln.seqs)
        aln_next = [-1] * n
        aln_to_uniq = [-1] * n
        last_of = {}
        for i, s in enumerate(aln.seqs):
            if s not in first_of:
                first_of[s] = i
                aln_to_uniq[i] = len(unique_seq)
                unique_seq.append(s)
                unique_first.append(i)
                last_of[s] = i
            else:
                last = last_of[s]
                aln_next[last] = i
                aln_to_uniq[i] = aln_to_uniq[first_of[s]]
                last_of[s] = i
        return cls(unique_seq, unique_first, aln_next, aln_to_uniq)


def seqs_to_codes(seqs: List[str], options, log=None) -> np.ndarray:
    """char -> code matrix [N, P] int8; unknowns & gaps -> NOCODE
    (ref seqsToProfiles NeighbourJoining.tcc:415-533, incl. character audits)."""
    n_codes = options.n_codes
    lut = np.full(256, n_codes, dtype=np.uint8)
    for i, c in enumerate(options.codes_string):
        lut[ord(c)] = i
        lut[ord(c.lower())] = i
    lut[ord("-")] = NOCODE

    n = len(seqs)
    n_pos = len(seqs[0]) if n else 0
    codes = np.empty((n, n_pos), dtype=np.uint8)
    counts = np.zeros(256, dtype=np.int64)
    for i, s in enumerate(seqs):
        b = np.frombuffer(s.encode("latin-1"), dtype=np.uint8)
        cnt = np.bincount(b, minlength=256)
        counts += cnt
        codes[i] = lut[b]
    codes[codes == n_codes] = NOCODE  # unknowns treated as gaps

    if log is not None:
        known = set(options.codes_string) | set(options.codes_string.lower()) | {"-"}
        for ci in range(256):
            if counts[ci] and chr(ci) not in known:
                print(f"Ignored unknown character {chr(ci)} (seen {counts[ci]} times)",
                      file=log)
        tot = counts.sum() - counts[ord("-")] - counts[ord(".")]
        acgt = sum(counts[ord(c)] for c in "ACGTUNacgtun")
        if tot > 0:
            frac = acgt / tot
            if n_codes == 4 and frac < 0.9:
                print(f"WARNING! ONLY {100*frac:.1f}% NUCLEOTIDE CHARACTERS -- IS THIS "
                      "REALLY A NUCLEOTIDE ALIGNMENT?", file=log)
            elif n_codes == 20 and frac >= 0.9:
                print(f"WARNING! {100*frac:.1f}% NUCLEOTIDE CHARACTERS -- IS THIS "
                      "REALLY A PROTEIN ALIGNMENT?", file=log)
    return codes.astype(np.int8)
