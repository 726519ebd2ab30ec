#!/usr/bin/env python
"""im2rec: pack an image folder / .lst file into RecordIO.

mxnet_tpu_torch's copy of tools/im2rec.py (ref: tools/im2rec.py and
tools/im2rec.cc), on mxnet_tpu_torch.recordio: generates .lst files
(`--list`) and packs images listed in them into .rec(+.idx) with
multi-threaded encode. PIL replaces OpenCV for decode/encode; its .lst,
.rec and .idx are byte-equal to tools/im2rec.py's on the same folder and
flags.

Usage:
  python tools/torch_im2rec.py --list prefix image_root   # write prefix.lst
  python tools/torch_im2rec.py prefix image_root          # pack prefix.lst -> prefix.rec
"""
from __future__ import annotations

import argparse
import os
import random
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mxnet_tpu_torch import recordio  # noqa: E402

_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def list_images(root, recursive):
    i = 0
    cat = {}
    if recursive:
        for path, _, files in sorted(os.walk(root)):
            for name in sorted(files):
                if name.lower().endswith(_EXTS):
                    rel = os.path.relpath(os.path.join(path, name), root)
                    label_dir = os.path.dirname(rel)
                    if label_dir not in cat:
                        cat[label_dir] = len(cat)
                    yield i, rel, cat[label_dir]
                    i += 1
    else:
        for name in sorted(os.listdir(root)):
            if name.lower().endswith(_EXTS):
                yield i, name, 0
                i += 1


def write_list(prefix, root, args):
    entries = list(list_images(root, args.recursive))
    if args.shuffle:
        random.seed(100)
        random.shuffle(entries)
    chunks = max(1, args.chunks)
    n = (len(entries) + chunks - 1) // chunks
    for c in range(chunks):
        suffix = "" if chunks == 1 else "_%d" % c
        with open(prefix + suffix + ".lst", "w") as f:
            for idx, rel, label in entries[c * n:(c + 1) * n]:
                f.write("%d\t%f\t%s\n" % (idx, label, rel))


def read_list(path):
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            idx = int(parts[0])
            labels = [float(x) for x in parts[1:-1]]
            yield idx, labels, parts[-1]


def _encode_one(item, root, args):
    import io as _io

    from PIL import Image

    idx, labels, rel = item
    path = os.path.join(root, rel)
    try:
        img = Image.open(path).convert("RGB")
    except Exception as e:  # noqa: BLE001
        print("skip %s: %s" % (path, e), file=sys.stderr)
        return idx, None
    if args.center_crop:
        w, h = img.size
        s = min(w, h)
        img = img.crop(((w - s) // 2, (h - s) // 2,
                        (w + s) // 2, (h + s) // 2))
    if args.resize:
        w, h = img.size
        if min(w, h) != args.resize:
            scale = args.resize / min(w, h)
            img = img.resize((max(1, round(w * scale)),
                              max(1, round(h * scale))))
    buf = _io.BytesIO()
    fmt = "PNG" if args.encoding == ".png" else "JPEG"
    img.save(buf, format=fmt, quality=args.quality)
    label = labels[0] if len(labels) == 1 else labels
    flag = 0 if len(labels) == 1 else len(labels)
    header = recordio.IRHeader(flag, label, idx, 0)
    return idx, recordio.pack(header, buf.getvalue())


def pack(prefix, root, args):
    lst = prefix + ".lst"
    if not os.path.isfile(lst):
        print("list file %s not found (run --list first)" % lst, file=sys.stderr)
        return 1
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    items = list(read_list(lst))
    with ThreadPoolExecutor(max_workers=args.num_thread) as pool:
        done = 0
        for idx, payload in pool.map(
                lambda it: _encode_one(it, root, args), items):
            if payload is not None:
                rec.write_idx(idx, payload)
            done += 1
            if done % 1000 == 0:
                print("packed %d/%d" % (done, len(items)))
    rec.close()
    return 0


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("prefix", help="prefix of .lst/.rec files")
    p.add_argument("root", help="image root folder")
    p.add_argument("--list", action="store_true", help="generate .lst only")
    p.add_argument("--recursive", action="store_true",
                   help="walk subdirs; dir names become labels")
    p.add_argument("--shuffle", action="store_true", default=True)
    p.add_argument("--no-shuffle", dest="shuffle", action="store_false")
    p.add_argument("--chunks", type=int, default=1)
    p.add_argument("--resize", type=int, default=0,
                   help="resize shorter edge to this")
    p.add_argument("--center-crop", action="store_true")
    p.add_argument("--quality", type=int, default=95)
    p.add_argument("--encoding", choices=[".jpg", ".png"], default=".jpg")
    p.add_argument("--num-thread", type=int, default=8)
    args = p.parse_args()
    if args.list:
        write_list(args.prefix, args.root, args)
        return 0
    return pack(args.prefix, args.root, args)


if __name__ == "__main__":
    sys.exit(main())
