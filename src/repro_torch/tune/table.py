"""Persistent tuning tables: measured plan winners, keyed per workload cell.

The port of :mod:`repro.tune.table`, in its file format. A tuning table is
one JSON file mapping

    (backend, shape-family, M, K, N, G, dtype, device-kind)  ->  (bm, bn, bk)
                                                                 [+ splits]

plus the measurement that justified the choice (steady-state microseconds of
device time, GFLOP/s, the analytic model's cycle estimate). On the H100 the
block names one of the kernel's compiled tile configurations and ``splits``
its K split count (written only when above 1, as ``fuse_epilogue`` is
written only when measured), so each package reads the other's files and
split-free entries save to the same bytes in both.
``repro_torch.kernels.ops`` consults the *active* table —
``$REPRO_TUNE_TABLE`` if set, else ``tables/default.json`` beside this
module, which the repo does not commit — before the plan heuristics.

Robustness contract (``tests/test_torch_tune.py``): a missing, corrupt, or
stale-schema table file never breaks a GEMM — the loader degrades to "no
table" with a single warning and every plan resolution falls back to the
heuristic. Entries are validated against the kernel's hard constraints at
lookup time (``ops._tuned_tile``): the table is a cache of *suggestions*,
never a trusted input.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import warnings
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

SCHEMA_VERSION = 1
ENV_VAR = "REPRO_TUNE_TABLE"
# The in-package default table (none is committed: a table comes from H100
# runs). Entries only apply on a matching device kind.
DEFAULT_TABLE_PATH = os.path.join(
    os.path.dirname(__file__), "tables", "default.json"
)

__all__ = [
    "SCHEMA_VERSION",
    "ENV_VAR",
    "DEFAULT_TABLE_PATH",
    "GemmShape",
    "TuneKey",
    "TuneEntry",
    "TuningTable",
    "TableFormatError",
    "active_table_path",
    "load_active_table",
    "device_kind",
]


class GemmShape(NamedTuple):
    """One workload cell: the unit the tuner measures and the table keys on.

    ``family`` is ``"dense"`` ([M,K] @ [K,N]) or ``"grouped"`` ([G,M,K] @
    [G,K,N] with (m, k, n) the per-group shape, ``g`` the group count —
    0 for dense).
    """

    family: str
    m: int
    k: int
    n: int
    g: int = 0
    dtype: str = "float32"


def device_kind() -> str:
    """Normalized name of the default CUDA device
    (``torch.cuda.get_device_name()``: "nvidia-h100-80gb-hbm3"), or "cpu"
    without one: the table's hardware discriminator."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    return str(torch.cuda.get_device_name()).strip().lower().replace(" ", "-")


def _dtype_itemsize(name: str) -> int:
    from repro_torch.core.roofline import dtype_width

    return dtype_width(name)


@dataclasses.dataclass(frozen=True)
class TuneKey:
    backend: str
    shape_family: str  # "dense" | "grouped"
    m: int
    k: int
    n: int
    g: int  # group count, 0 for dense
    dtype: str  # operand dtype name as quantized/streamed by the backend
    device_kind: str

    def to_json(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, object]) -> "TuneKey":
        return cls(
            backend=str(d["backend"]),
            shape_family=str(d["shape_family"]),
            m=int(d["m"]), k=int(d["k"]), n=int(d["n"]), g=int(d["g"]),
            dtype=str(d["dtype"]),
            device_kind=str(d["device_kind"]),
        )


@dataclasses.dataclass(frozen=True)
class TuneEntry:
    key: TuneKey
    block: Tuple[int, int, int]  # (bm, bn, bk): one of the kernel's compiled tiles
    us: float  # steady-state time of the winner
    gflops: float
    # The reference's pruner's estimate; the port's tuner times every plan
    # and writes None.
    modeled_cycles: Optional[int] = None
    source: str = "measured"
    # Measured fused-vs-post-hoc epilogue verdict for this cell: True =
    # fusing the epilogue into the writeback was at least as fast, False =
    # the post-hoc pass won (operand streaming perturbed the pipelining),
    # None = never measured — ops falls back to fuse-by-default. Optional
    # JSON field: tables written before this field existed load unchanged
    # (from_json reads known keys only), so the schema version stays 1.
    fuse_epilogue: Optional[bool] = None
    # K split count of the plan (K1, K2 on the sm90 route). Written only
    # when above 1, so an entry without splits saves to the reference's
    # bytes, and the reference's reader (known keys only) skips it.
    splits: int = 1

    def to_json(self) -> Dict[str, object]:
        d = self.key.to_json()
        d.update(
            block=list(self.block), us=self.us, gflops=self.gflops,
            modeled_cycles=self.modeled_cycles, source=self.source,
        )
        if self.fuse_epilogue is not None:
            d["fuse_epilogue"] = self.fuse_epilogue
        if self.splits > 1:
            d["splits"] = self.splits
        return d

    @classmethod
    def from_json(cls, d: Dict[str, object]) -> "TuneEntry":
        block = d["block"]
        if not (isinstance(block, (list, tuple)) and len(block) == 3):
            raise TableFormatError(f"bad block {block!r}")
        fuse = d.get("fuse_epilogue")
        return cls(
            key=TuneKey.from_json(d),
            block=(int(block[0]), int(block[1]), int(block[2])),
            us=float(d.get("us", 0.0)),
            gflops=float(d.get("gflops", 0.0)),
            modeled_cycles=(
                int(d["modeled_cycles"])
                if d.get("modeled_cycles") is not None else None
            ),
            source=str(d.get("source", "measured")),
            fuse_epilogue=None if fuse is None else bool(fuse),
            splits=int(d.get("splits", 1)),
        )


class TableFormatError(ValueError):
    """The file exists but is not a valid tuning table (corrupt JSON, wrong
    schema version, malformed entry). The loader treats it as 'no table'."""


class TuningTable:
    """In-memory tuning table with JSON round-trip and itemsize-keyed lookup.

    Lookup is by element *width*, not dtype name: tile selection cares about
    bytes moved per element (exactly like the heuristics, which key on
    ``itemsize``), so an entry tuned at float32 serves int32 and an entry
    tuned at bfloat16 serves float16. Entries for other device kinds are
    carried through load/save untouched but never served.
    """

    def __init__(self, entries: Iterable[TuneEntry] = ()):
        self._entries: Dict[TuneKey, TuneEntry] = {}
        self._index: Dict[Tuple, TuneEntry] = {}
        self._fusion_index: Dict[Tuple, bool] = {}
        for e in entries:
            self.put(e)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def entries(self) -> List[TuneEntry]:
        return list(self._entries.values())

    @staticmethod
    def _index_key(
        backend: str, shape_family: str, m: int, k: int, n: int, g: int,
        itemsize: int, device: str,
    ) -> Tuple:
        return (backend, shape_family, m, k, n, g, itemsize, device)

    def put(self, entry: TuneEntry) -> None:
        self._entries[entry.key] = entry
        try:
            itemsize = _dtype_itemsize(entry.key.dtype)
        except Exception:
            return  # unknown dtype name: keep the entry, never serve it
        ikey = self._index_key(
            entry.key.backend, entry.key.shape_family,
            entry.key.m, entry.key.k, entry.key.n, entry.key.g,
            itemsize, entry.key.device_kind,
        )
        self._index[ikey] = entry
        if entry.fuse_epilogue is not None:
            self._fusion_index[ikey] = entry.fuse_epilogue
        else:
            # A re-tuned entry without a fusion verdict supersedes any stale
            # verdict the replaced entry carried.
            self._fusion_index.pop(ikey, None)

    def get(self, key: TuneKey) -> Optional[TuneEntry]:
        return self._entries.get(key)

    def lookup(
        self,
        *,
        backend: str,
        shape_family: str,
        m: int,
        k: int,
        n: int,
        g: int = 0,
        itemsize: int,
        device: Optional[str] = None,
    ) -> Optional[Tuple[int, int, int]]:
        """The tuned (bm, bn, bk) for this cell on this device, or None."""
        entry = self.lookup_entry(
            backend=backend, shape_family=shape_family, m=m, k=k, n=n, g=g,
            itemsize=itemsize, device=device,
        )
        return None if entry is None else entry.block

    def lookup_entry(
        self,
        *,
        backend: str,
        shape_family: str,
        m: int,
        k: int,
        n: int,
        g: int = 0,
        itemsize: int,
        device: Optional[str] = None,
    ) -> Optional[TuneEntry]:
        """The tuned entry (its block and split count) for this cell on this
        device, or None."""
        return self._index.get(self._index_key(
            backend, shape_family, m, k, n, g, itemsize,
            device if device is not None else device_kind(),
        ))

    def lookup_fusion(
        self,
        *,
        backend: str,
        shape_family: str,
        m: int,
        k: int,
        n: int,
        g: int = 0,
        itemsize: int,
        device: Optional[str] = None,
    ) -> Optional[bool]:
        """The measured fused-vs-post-hoc epilogue verdict for this cell on
        this device, or None when the tuner never measured one (ops then
        fuses by default on capable backends)."""
        return self._fusion_index.get(self._index_key(
            backend, shape_family, m, k, n, g, itemsize,
            device if device is not None else device_kind(),
        ))

    def merge(self, other: "TuningTable") -> None:
        """Adopt ``other``'s entries (other wins on key conflicts)."""
        for e in other.entries:
            self.put(e)

    # -- persistence --------------------------------------------------------

    def to_json(self) -> Dict[str, object]:
        return {
            "schema": SCHEMA_VERSION,
            "entries": [e.to_json() for e in self._entries.values()],
        }

    @classmethod
    def from_json(cls, doc: object) -> "TuningTable":
        if not isinstance(doc, dict):
            raise TableFormatError(f"table root is {type(doc).__name__}, not object")
        if doc.get("schema") != SCHEMA_VERSION:
            raise TableFormatError(
                f"table schema {doc.get('schema')!r} != supported {SCHEMA_VERSION}"
            )
        raw = doc.get("entries")
        if not isinstance(raw, list):
            raise TableFormatError("table has no entries list")
        try:
            return cls(TuneEntry.from_json(d) for d in raw)
        except (KeyError, TypeError, ValueError) as e:
            raise TableFormatError(f"malformed table entry: {e}") from e

    @classmethod
    def load(cls, path: str) -> "TuningTable":
        """Load a table; raises FileNotFoundError / TableFormatError.

        (Use :func:`load_active_table` for the never-raises behaviour the
        GEMM hot path needs.)
        """
        with open(path) as f:
            try:
                doc = json.load(f)
            except json.JSONDecodeError as e:
                raise TableFormatError(f"corrupt table JSON: {e}") from e
        return cls.from_json(doc)

    def save(self, path: str) -> None:
        """Atomic write (tmp file + rename): a reader — another serving
        process mid-resolution — never observes a half-written table."""
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_json(), f, indent=1, sort_keys=True)
                f.write("\n")
            os.chmod(tmp, 0o644)  # mkstemp's 0600 is wrong for a shared table
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


def active_table_path() -> str:
    """Where the active table lives: ``$REPRO_TUNE_TABLE`` overrides the
    in-package default."""
    return os.environ.get(ENV_VAR) or DEFAULT_TABLE_PATH


def load_active_table() -> Optional[TuningTable]:
    """The table ``ops._tile_for`` consults; never raises.

    Missing file -> None silently (most processes have no table). A file
    that exists but cannot be parsed (corrupt JSON, wrong schema, malformed
    entries) -> None with one RuntimeWarning naming the path: GEMMs keep
    running on heuristics, exactly as if there were no table.
    """
    path = active_table_path()
    if not os.path.exists(path):
        return None
    try:
        return TuningTable.load(path)
    except (TableFormatError, OSError) as e:
        warnings.warn(
            f"ignoring unusable tuning table {path!r}: {e}",
            RuntimeWarning,
            stacklevel=2,
        )
        return None
