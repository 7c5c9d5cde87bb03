"""Corrupted JPEG 2000 bodies against ``cv2.imdecode``: the generator
``tests/test_torch_jpeg2000.py`` draws a few hundred bodies from, and a
longer pass of it that counts how the port and cv2 agree.

    python tests/torch_fixtures/fuzz_jpeg2000.py --seeds 0 10 --bodies 500

Each body is one of four small files written by OpenJPEG's encoder (a JP2
with 8x8 code-blocks, an irreversible layered J2K, a grey J2K with SOP,
EPH and every code-block style, a tiled RPCL JP2 with precincts), cut short,
with 1-3 bytes set or with one bit flipped.  A body agrees where cv2 and
the port give the same image under a flag, or where cv2 gives none and the
port gives none or raises naming a JPEG 2000 fault; an image past the
port's size limit (ROADMAP's deliberate divergences) is counted apart.  It
needs cv2 and PIL.
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from tests.torch_fixtures.make_fixtures import opj_encode  # noqa: E402


def bases(rng) -> list:
    import cv2

    img = rng.randint(0, 256, (21, 27, 3)).astype(np.uint8)
    img = cv2.GaussianBlur(img, (0, 0), 2).astype(np.int32)
    planes = [img[:, :, k] for k in range(3)]
    return [opj_encode(planes, numres=3, cblk=(8, 8)),
            opj_encode(planes, numres=3, jp2=False, irreversible=True, layers=[30, 10]),
            opj_encode(planes[:1], numres=2, jp2=False, space="gray", sop=True, eph=True,
                       mode=0x3F),
            opj_encode(planes, numres=3, tile=(16, 16), prog="RPCL",
                       precincts=[(16, 16), (8, 8), (4, 4)])]


def corrupt(rng, base: bytes) -> bytes:
    data = bytearray(base)
    kind = rng.randint(3)
    if kind == 0:
        data = data[:rng.randint(1, len(data))]
    elif kind == 1:
        for _ in range(rng.randint(1, 4)):
            data[rng.randint(len(data))] = rng.randint(256)
    else:
        data[rng.randint(len(data))] ^= 1 << rng.randint(8)
    return bytes(data)


def outcome(data: bytes, flags: int) -> str:
    """"equal", "both none", or how the two differ."""
    import cv2

    from unopticalflow_tpu_torch.utils import imageio

    try:
        want = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
    except cv2.error:
        want = None
    try:
        got = imageio.imdecode(data, flags)
    except ValueError as e:
        if not str(e).startswith("JPEG 2000: "):
            return f"port raises {e}"
        if "the port decodes up to" in str(e) and want is not None:
            return "past the port's size limit"  # a deliberate divergence (ROADMAP)
        got = None
    if want is None:
        return "both none" if got is None else "port decodes, cv2 gives none"
    if got is None:
        return "cv2 decodes, port gives none"
    same = got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)
    return "equal" if same else "both decode, values differ"


def main(argv=None) -> int:
    import cv2

    from unopticalflow_tpu_torch.utils import imageio

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs=2, default=(0, 10), help="first, end")
    ap.add_argument("--bodies", type=int, default=500, help="bodies a seed")
    ap.add_argument("--dump", help="a directory to write each disagreeing body to")
    args = ap.parse_args(argv)
    tally, flags_all = {}, (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE, cv2.IMREAD_UNCHANGED)
    bodies = 0
    for seed in range(*args.seeds):
        rng = np.random.RandomState(seed)
        files = bases(rng)
        for _ in range(args.bodies):
            data = corrupt(rng, files[rng.randint(len(files))])
            if imageio._decoder(data) is None:
                continue
            bodies += 1
            for flags in flags_all:
                res = outcome(data, flags)
                tally[res] = tally.get(res, 0) + 1
                if args.dump and res not in ("equal", "both none"):
                    os.makedirs(args.dump, exist_ok=True)
                    with open(os.path.join(args.dump, f"{seed}_{bodies}_{flags}.bin"), "wb") as f:
                        f.write(data)
    print(json.dumps({"bodies": bodies, "decodes": sum(tally.values()), "outcomes": tally}))
    return 0 if set(tally) <= {"equal", "both none", "past the port's size limit"} else 1


if __name__ == "__main__":
    sys.exit(main())
