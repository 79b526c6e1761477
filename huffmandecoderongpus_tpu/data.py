"""Corpora: the 8 test datasets, generated in the checkout from a seed.

A test dataset pairs uncompressed bytes with their ``<name>.huff``
(loadTestData semantics, reference framework/huffdata.c:205-215).  The
reference's corpus files are not redistributed, so each one is replaced by a
generated stream with its name, its exact raw size, its alphabet size and
(within a few per cent) its compression ratio:

* text corpora are a seeded shuffle of symbol counts drawn from one fixed
  English-like frequency table (:data:`ENGLISH_SYMBOLS` /
  :data:`ENGLISH_WEIGHTS`), sharpened or flattened per corpus by an
  exponent and given a floor count for the rarest symbols, which sets the
  tree height;
* ``E.coli`` is a 4-symbol DNA-like stream (7 tree nodes, 2-bit codes);
* ``hello`` is the 11-byte literal of the reference's worked example.

The generated bytes are the ground truth; the ``.huff`` is this package's
own encoder output (huffio/encoder.py).  Both are written once per seed to
the git-ignored ``.cache/`` directory of the checkout.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import tempfile

import numpy as np

from huffmandecoderongpus_tpu.huffio.format import HuffFile, read_huff, write_huff

#: Scratch directory of the checkout (git-ignored): generated corpora and
#: the default compile cache live under it.
CACHE_DIR = pathlib.Path(__file__).resolve().parent.parent / ".cache"

DEFAULT_SEED = 0

#: Bumped whenever the generator's output changes, so stale files are not
#: reused.
GENERATOR_VERSION = 1

#: All 8 corpora, in the reference's naming. mainrun.c:503-509 loads the first
#: five; the others are exercised by the wider suites.
CORPUS_NAMES = [
    "hello",
    "paper1",
    "news",
    "book2",
    "kjv.txt",
    "E.coli",
    "bible.txt",
    "world192.txt",
]

#: The five datasets mainrun.c loads for its suites (mainrun.c:503-509).
MAINRUN_NAMES = ["hello", "paper1", "news", "book2", "kjv.txt"]

#: English-like symbol ranks and relative frequencies (per 100k characters of
#: prose, most frequent first): 95 printable ASCII symbols plus tab, CR, LF.
ENGLISH_SYMBOLS = (
    b" etaoinshrdlucmfwgypb,.vk\nTIA\"'SHWMBCxj-ELNDqzOGPRFY;:!?JKUV012()354986"
    b"7QXZ*/&[]_#$%+=<>@\t|\\~^`{}\r"
)
ENGLISH_WEIGHTS = (
    # the rarest 38 symbols fall off geometrically (x0.82 per rank)
    17000, 9500, 6800, 6100, 5900, 5400, 5300, 5000, 4900, 4600,
    3300, 3100, 2100, 2000, 1900, 1700, 1650, 1550, 1450, 1350,
    1150, 1050, 950, 780, 580, 520, 300, 270, 230, 200,
    180, 170, 150, 135, 125, 115, 115, 110, 100, 95,
    90, 85, 85, 80, 75, 70, 68, 66, 64, 62,
    58, 50, 48, 42, 40, 38, 36, 30, 28, 26,
    21.0, 17.0, 14.0, 12.0, 9.6, 7.9, 6.5, 5.3, 4.4, 3.6,
    2.9, 2.4, 2.0, 1.6, 1.3, 1.1, 0.89, 0.73, 0.6, 0.49,
    0.4, 0.33, 0.27, 0.22, 0.18, 0.15, 0.12, 0.1, 0.082, 0.068,
    0.055, 0.045, 0.037, 0.031, 0.025, 0.021, 0.017, 0.014,
)


@dataclasses.dataclass(frozen=True)
class TextSpec:
    """A text corpus: the first ``symbols`` entries of the English table,
    weights raised to ``alpha``, every symbol at least ``floor`` times."""

    size: int  # raw bytes (BASELINE.md corpus table)
    symbols: int  # alphabet size (tree nodes = 2 * symbols - 1)
    alpha: float  # < 1 flattens the distribution (raises the ratio)
    floor: int  # count of the rarest symbols; sets the tree height


#: Per-corpus shapes.  Sizes and the node counts of paper1 (189) and kjv.txt
#: (167, height 19) are the reference's; ``alpha`` and ``floor`` were fitted
#: once so the compressed/raw ratio lands within 3% of the reference's.
TEXT_SPECS = {
    "paper1": TextSpec(53_161, 95, 0.72, 3),
    "news": TextSpec(377_109, 98, 0.62, 1),
    "book2": TextSpec(610_856, 96, 0.80, 3),
    "kjv.txt": TextSpec(5_504_597, 84, 1.00, 1),
    "bible.txt": TextSpec(4_047_392, 63, 1.04, 1),
    "world192.txt": TextSpec(2_473_400, 94, 0.71, 1),
}
ECOLI_SIZE = 4_638_690
ECOLI_WEIGHTS = {b"a": 2462, b"c": 2543, b"g": 2537, b"t": 2458}
HELLO = b"Hello World"


@dataclasses.dataclass
class TestData:
    """A named (compressed, uncompressed ground truth) pair
    (reference: struct TestData, huffdata.h:19-23)."""

    __test__ = False  # not a pytest test class

    name: str
    cd: HuffFile
    ucd: np.ndarray  # uint8 ground-truth bytes

    def info(self) -> str:
        return (
            f"{self.name} nodes {self.cd.nodes}, bits {self.cd.bits}, "
            f"uncompressedsize {self.cd.uncompressed_size}"
        )


def _shuffled_counts(symbols: bytes, weights, size: int, floor: int,
                     rng: np.random.Generator) -> np.ndarray:
    """``size`` bytes holding each symbol ``floor + share`` times (shares in
    proportion to ``weights``), in a seeded random order."""
    w = np.asarray(weights, dtype=np.float64)
    counts = np.floor((size - floor * w.size) * w / w.sum()).astype(np.int64)
    counts += floor
    counts[0] += size - counts.sum()
    syms = np.frombuffer(symbols, dtype=np.uint8)
    return rng.permutation(np.repeat(syms, counts))


def generate_corpus(name: str, seed: int = DEFAULT_SEED,
                    size: int | None = None) -> np.ndarray:
    """The raw bytes of corpus ``name`` for ``seed``.

    ``size`` overrides the corpus's byte count while keeping its symbol
    distribution (e.g. a kjv-shaped stream larger than the card's L2)."""
    if name == "hello":
        if size is not None:
            raise ValueError("hello is a fixed literal")
        return np.frombuffer(HELLO, dtype=np.uint8).copy()
    rng = np.random.default_rng([seed, CORPUS_NAMES.index(name)])
    if name == "E.coli":
        return _shuffled_counts(b"".join(ECOLI_WEIGHTS), list(ECOLI_WEIGHTS.values()),
                                size or ECOLI_SIZE, 0, rng)
    spec = TEXT_SPECS[name]
    weights = np.asarray(ENGLISH_WEIGHTS[: spec.symbols], np.float64) ** spec.alpha
    return _shuffled_counts(ENGLISH_SYMBOLS[: spec.symbols], weights,
                            size or spec.size, spec.floor, rng)


def corpus_dir(seed: int = DEFAULT_SEED) -> pathlib.Path:
    return CACHE_DIR / "corpora" / f"v{GENERATOR_VERSION}-seed{seed}"


def _write_atomic(path: pathlib.Path, write) -> None:
    # concurrent test workers may generate the same file: each writes a
    # private temporary and renames it into place
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".")
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def ensure_corpus(name: str, seed: int = DEFAULT_SEED) -> pathlib.Path:
    """Generate corpus ``name`` (raw bytes + ``.huff``) unless present;
    returns the raw file's path."""
    from huffmandecoderongpus_tpu.huffio.encoder import encode_bytes

    if name not in CORPUS_NAMES:
        raise KeyError(f"unknown corpus {name!r} (known: {CORPUS_NAMES})")
    raw_p = corpus_dir(seed) / name
    huff_p = corpus_dir(seed) / f"{name}.huff"
    if raw_p.exists() and huff_p.exists():
        return raw_p
    raw_p.parent.mkdir(parents=True, exist_ok=True)
    raw = generate_corpus(name, seed)
    _write_atomic(huff_p, lambda p: write_huff(p, encode_bytes(raw)))
    _write_atomic(raw_p, raw.tofile)
    return raw_p


def raw_path(name: str, seed: int = DEFAULT_SEED) -> pathlib.Path:
    return ensure_corpus(name, seed)


def huff_path(name: str, seed: int = DEFAULT_SEED) -> pathlib.Path:
    ensure_corpus(name, seed)
    return corpus_dir(seed) / f"{name}.huff"


def load_huff(name: str, seed: int = DEFAULT_SEED) -> HuffFile:
    return read_huff(huff_path(name, seed))


def load_ground_truth(name: str, seed: int = DEFAULT_SEED) -> np.ndarray:
    return np.fromfile(raw_path(name, seed), dtype=np.uint8)


def load_test_data(name: str, seed: int = DEFAULT_SEED) -> TestData:
    """Load one corpus as a TestData pair (huffdata.c:205-215 semantics)."""
    return TestData(name=name, cd=load_huff(name, seed),
                    ucd=load_ground_truth(name, seed))
