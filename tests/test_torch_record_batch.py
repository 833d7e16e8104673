"""The port's record-batch codec (`fluidframework_tpu_torch.protocol.
record_batch`) against the JAX package's, exactly.

With the owner and fence pinned, `encode_batch` and `encode_columns`
give byte-identical frames in both packages for the same records: v1
and v2 frames, boxcars, ``K_GENERIC`` strays, the ``FLAG_SRC`` tag and
``inOff`` on raw kinds. Each package decodes the other's frames to
equal records (and equal boxcar ops, blob bytes included); `mask_runs`,
`count_records` and the unit scanner `iter_units` (torn tails, corrupt
frames, JSON lines between frames) agree.
"""

import json
import random

import numpy as np
import pytest

from fluidframework_tpu.protocol import record_batch as jrb
from fluidframework_tpu_torch.protocol import record_batch as trb

OWNER, FENCE = "deli-g3", 11


def _records(seed: int):
    """Every kind the codec knows, K_GENERIC strays among them."""
    rng = random.Random(seed)
    recs = []
    for i in range(60):
        doc = f"doc{rng.randrange(5)}"
        c = rng.randrange(1, 6)
        r = rng.random()
        if r < 0.25:
            rec = {"kind": "op", "doc": doc, "client": c, "clientSeq": i,
                   "refSeq": rng.randrange(i + 1),
                   "contents": {"v": rng.randrange(999), "s": "x" * (i % 7),
                                "l": [i, None, True]}}
            if rng.random() < 0.3:
                rec["inOff"] = rng.randrange(10_000)  # raw kind + inOff
            recs.append(rec)
        elif r < 0.35:
            recs.append({"kind": rng.choice(("join", "leave")), "doc": doc,
                         "client": c})
        elif r < 0.45:
            recs.append({"kind": "boxcar", "doc": doc, "client": c,
                         "ops": [{"clientSeq": i + k, "refSeq": k,
                                  "contents": {"k": k, "u": "é"}}
                                 for k in range(rng.randrange(0, 4))]})
        elif r < 0.70:
            recs.append({"kind": "op", "doc": doc, "seq": i + 1,
                         "msn": i // 2, "client": c, "clientSeq": i,
                         "refSeq": i // 3,
                         "type": rng.choice(("op", "join", "leave")),
                         "contents": rng.choice((c, {"a": [1, 2]}, "s")),
                         "inOff": i})
        elif r < 0.80:
            recs.append({"kind": "nack", "doc": doc, "client": c,
                         "clientSeq": i, "code": rng.choice((400, 403, 422)),
                         "reason": f"clientSeq {i}, expected {i - 1}",
                         "inOff": i})
        else:  # strays: each falls to K_GENERIC
            recs.append(rng.choice((
                {"junk": i},
                {"kind": "op", "doc": doc, "client": c, "clientSeq": i,
                 "refSeq": 0, "contents": 1, "extra": True},
                {"kind": "op", "doc": doc, "client": c, "clientSeq": i,
                 "refSeq": 0, "contents": 1, "inOff": -4},
                {"kind": "op", "doc": doc, "client": 1 << 70,
                 "clientSeq": i, "refSeq": 0, "contents": None},
                {"kind": "op", "doc": doc, "seq": 3, "msn": 1, "client": c,
                 "clientSeq": 1, "refSeq": 0, "type": "custom",
                 "contents": 0, "inOff": i},
                [1, 2, 3],
                "a string record",
            )))
    return recs


def _columns(pkg, seed: int):
    """One `ColumnarRecords` segment of sequenced ops and nacks, the
    same arrays in either package."""
    rng = np.random.default_rng(seed)
    n = 40
    kinds = np.where(rng.random(n) < 0.8, pkg.K_SEQ_OP, pkg.K_NACK)
    tc = np.where(kinds == pkg.K_SEQ_OP,
                  rng.integers(0, 3, n), 255).astype(np.uint8)
    blobs = [json.dumps({"i": int(i)}, separators=(",", ":")).encode()
             for i in range(n)]
    off = np.zeros(n + 1, np.uint32)
    off[1:] = np.cumsum([len(b) for b in blobs])
    return pkg.ColumnarRecords(
        ["a", "b", "c"], kinds, tc, rng.integers(0, 3, n),
        rng.integers(1, 9, n), rng.integers(0, 99, n),
        rng.integers(0, 99, n), rng.integers(1, 999, n),
        rng.integers(0, 99, n), np.arange(100, 100 + n),
        off, b"".join(blobs))


def _canon(rec):
    """A decoded record in a form either package's values compare in
    (a `JsonBlob` of either package as its value)."""
    def default(o):
        return json.loads(o.raw)
    return json.dumps(rec, sort_keys=True, default=default)


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("src", [None, "deli-p7"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_batch_bytes_identical(version, src, seed):
    recs = _records(seed)
    a = trb.encode_batch(recs, fence=FENCE, owner=OWNER, version=version,
                         src=src)
    b = jrb.encode_batch(recs, fence=FENCE, owner=OWNER, version=version,
                         src=src)
    assert a == b
    # the frame carries the pinned stamp and the src flag
    batch, end, n = trb.decode_batch(a)
    assert (end, n, batch.fence, batch.owner, batch.src, batch.version) \
        == (len(a), len(recs), FENCE, OWNER, src, version)
    kinds = set(batch.kind.tolist())
    assert {trb.K_RAW_OP, trb.K_RAW_BOXCAR, trb.K_SEQ_OP, trb.K_NACK,
            trb.K_GENERIC} <= kinds


@pytest.mark.parametrize("version", [1, 2])
def test_encode_columns_bytes_identical(version):
    segs_t = [_columns(trb, 3), _columns(trb, 4)]
    segs_j = [_columns(jrb, 3), _columns(jrb, 4)]
    assert trb.encode_columns(segs_t, fence=FENCE, owner=OWNER,
                              version=version) == \
        jrb.encode_columns(segs_j, fence=FENCE, owner=OWNER,
                           version=version)
    # segments spliced between plain records keep their stream position
    plain = _records(5)[:9]
    mixed_t = plain[:4] + [segs_t[0]] + plain[4:] + [segs_t[1]]
    mixed_j = plain[:4] + [segs_j[0]] + plain[4:] + [segs_j[1]]
    a = trb.encode_batch(mixed_t, fence=FENCE, owner=OWNER, version=version)
    assert a == jrb.encode_batch(mixed_j, fence=FENCE, owner=OWNER,
                                 version=version)
    assert trb.count_records(mixed_t) == jrb.count_records(mixed_j) == \
        9 + 80
    got = [_canon(r) for r in trb.decode_batch(a)[0].records()]
    want = [_canon(r) for r in plain[:4]] + \
        [_canon(r) for r in segs_t[0].records()] + \
        [_canon(r) for r in plain[4:]] + \
        [_canon(r) for r in segs_t[1].records()]
    assert got == want


def _decoded(batch):
    recs = [_canon(r) for r in batch.records()]
    boxes = [
        [(cs, rf, c.raw if hasattr(c, "raw") else _canon(c))
         for cs, rf, c in batch.boxcar(i)]
        for i in range(batch.n) if int(batch.kind[i]) == batch_kind_boxcar
    ]
    cols = [np.asarray(getattr(batch, f)).tolist()
            for f in ("kind", "type_code", "doc_idx", "client",
                      "client_seq", "ref_seq", "seq", "msn", "in_off")]
    blobs = [batch.blob(i) for i in range(batch.n)]
    return recs, boxes, cols, blobs, batch.docs, batch.src


batch_kind_boxcar = trb.K_RAW_BOXCAR


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("src", [None, "r3"])
def test_cross_decode(version, src):
    """Each package decodes the other's frames to equal records,
    columns, blobs and boxcar ops; both equal the input records."""
    recs = _records(7)
    ft = trb.encode_batch(recs, fence=FENCE, owner=OWNER, version=version,
                          src=src)
    fj = jrb.encode_batch(recs, fence=FENCE, owner=OWNER, version=version,
                          src=src)
    views = [_decoded(pkg.decode_batch(f)[0])
             for pkg in (trb, jrb) for f in (ft, fj)]
    assert all(v == views[0] for v in views[1:])
    want = [_canon(dict(r, inSrc=src) if src and isinstance(r, dict) else r)
            for r in recs]
    assert views[0][0] == want


def test_mask_runs_and_count_records_agree():
    rng = np.random.default_rng(9)
    for n in (0, 1, 2, 17, 300):
        for vals in (rng.integers(0, 3, n), rng.random(n) < 0.8,
                     np.zeros(n, np.int8)):
            assert trb.mask_runs(vals) == jrb.mask_runs(vals)
    segs = [_columns(trb, 1), {"junk": 1}, _columns(trb, 2), 5]
    segs_j = [_columns(jrb, 1), {"junk": 1}, _columns(jrb, 2), 5]
    assert trb.count_records(segs) == jrb.count_records(segs_j) == 82


def test_iter_units_agree_on_torn_corrupt_and_mixed_bytes():
    """Frames, JSON lines between them, a frame with a flipped payload
    byte (CRC bad: skipped, records still counted), a garbled header
    (resync) and a torn tail scan to the same units in both packages,
    at every cut of the byte string."""
    f1 = trb.encode_batch(_records(1)[:20], fence=1, owner="a")
    f2 = bytearray(trb.encode_batch(_records(2)[:15], fence=2, owner="b"))
    f2[-3] ^= 0xFF  # payload corruption
    f3 = bytearray(trb.encode_batch(_records(3)[:10], fence=3, owner="c"))
    f3[5] = 77  # unknown version byte: header hit
    f4 = trb.encode_batch(_records(4)[:12], fence=4, owner="d")
    data = (f1 + b'{"kind": "join", "doc": "x", "client": 1}\n'
            + bytes(f2) + b"not json\n" + bytes(f3) + f4)

    def units(pkg, buf):
        out = []
        for u in pkg.iter_units(buf):
            out.append(tuple(_decoded(x) if hasattr(x, "records") else x
                             for x in u))
        return out

    cuts = sorted({len(data), len(data) - 1, len(data) - 40,
                   len(f1) + 5, len(f1) + 43, len(f1) + 43 + len(f2)}
                  | set(range(0, len(data), 97)))
    for cut in cuts:
        buf = data[:cut]
        assert units(trb, buf) == units(jrb, buf), cut
