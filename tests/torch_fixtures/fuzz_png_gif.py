"""Generated PNG, APNG and GIF bodies against ``cv2.imdecode``: a longer
pass of the generators ``tests/test_torch_png_depths.py`` and
``tests/test_torch_gif.py`` draw a few hundred bodies from, counting how
the port and cv2 agree.

    python tests/torch_fixtures/fuzz_png_gif.py --kind png --seeds 0 10 --bodies 1000
    python tests/torch_fixtures/fuzz_png_gif.py --kind gif --seeds 0 10 --bodies 1000

Each body is a generated file, whole or (``--damage``, half the bodies)
cut short, with 1-2 bytes set or, for PNG, one chunk's CRC flipped.  Under
each flag a body is "equal" where cv2 and the port give the same image,
"both none" where both give none, "refused" where cv2 gives none and the
port raises (a plain PNG's fault), "undefined" where the port raises a
case whose output cv2 leaves undefined, else "differ".  No grey APNG is
drawn: cv2 5.0 overruns a buffer on them.  cv2 aborts now and then on a
damaged body (its heap, not the port): each seed runs in a process of its
own, and a seed whose process dies is rerun from the body after the one
that killed it, counted under "cv2 aborted".  Prints one JSON line.  It
needs cv2 and PIL.
"""

import argparse
import collections
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)


def damage(rng, data: bytes, kind: str) -> bytes:
    b = bytearray(data)
    r = rng.rand()
    if r < 0.4:
        return bytes(b[:rng.randint(8, len(b))])
    if kind == "png" and r < 0.7:  # one chunk's CRC flipped
        pos, ends = 8, []
        while pos + 8 <= len(b):
            n = int.from_bytes(b[pos:pos + 4], "big")
            ends.append(pos + 8 + n)
            pos += 12 + n
        end = ends[rng.randint(len(ends))]
        if end < len(b):
            b[end] ^= 1
        return bytes(b)
    for _ in range(rng.randint(1, 3)):
        b[rng.randint(6, len(b))] = rng.randint(256)
    return bytes(b)


def outcome(data: bytes, flags: int, kind: str) -> str:
    import cv2

    from unopticalflow_tpu_torch.utils import imageio

    want = cv2.imdecode(np.frombuffer(data, np.uint8), flags)
    try:
        got = imageio.imdecode(data, flags)
    except ValueError as e:
        if "undefined" in str(e) or "overruns" in str(e):
            return "undefined"
        return "refused" if want is None else "differ (raised)"
    if want is None:
        return "both none" if got is None else "differ (port decodes)"
    if got is None:
        return "differ (port none)"
    same = got.dtype == want.dtype and got.shape == want.shape and np.array_equal(got, want)
    return "equal" if same else "differ"


def run_seed(kind: str, seed: int, bodies: int, damaged: bool, start: int, progress: str):
    """Counts of one seed's bodies from ``start`` on, writing the index of
    the body under way and the counts before it to ``progress``."""
    if kind == "png":
        from tests.test_torch_png_depths import _fuzz_file
    else:
        from tests.test_torch_gif import _fuzz_file
    rng = np.random.RandomState(seed)
    counts = collections.Counter()
    for i in range(bodies):
        data = _fuzz_file(rng)
        if damaged and rng.rand() < 0.5:
            data = damage(rng, data, kind)
        if i < start:
            continue
        with open(progress, "w") as f:
            json.dump({"body": i, "counts": counts}, f)
        for flags in (1, 0, -1):
            counts[outcome(data, flags, kind)] += 1
    return counts


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--kind", choices=("png", "gif"), required=True)
    p.add_argument("--seeds", type=int, nargs=2, default=(0, 4))
    p.add_argument("--bodies", type=int, default=500)
    p.add_argument("--damage", action="store_true")
    p.add_argument("--child", type=int, nargs=2, default=None)  # seed, first body
    p.add_argument("--progress", default=None)
    args = p.parse_args(argv)
    if args.child:
        counts = run_seed(args.kind, args.child[0], args.bodies, args.damage, args.child[1],
                          args.progress)
        print(json.dumps(counts))
        return 0
    total, aborted = collections.Counter(), 0
    progress = os.path.join(REPO, "build", f"fuzz_{args.kind}_{args.seeds[0]}_{args.seeds[1]}"
                            f"{'_damage' if args.damage else ''}.progress")
    os.makedirs(os.path.dirname(progress), exist_ok=True)
    for seed in range(*args.seeds):
        start = 0
        while True:
            cmd = [sys.executable, os.path.abspath(__file__), "--kind", args.kind,
                   "--bodies", str(args.bodies), "--child", str(seed), str(start),
                   "--progress", progress] + (["--damage"] if args.damage else [])
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode == 0:
                total.update(json.loads(r.stdout.strip().splitlines()[-1]))
                break
            with open(progress) as f:
                state = json.load(f)
            total.update(state["counts"])
            start = state["body"] + 1
            aborted += 1
    print(json.dumps({"kind": args.kind, "seeds": list(args.seeds), "bodies": args.bodies,
                      "damage": args.damage, "outcomes": dict(total),
                      "cv2 aborted": aborted}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
