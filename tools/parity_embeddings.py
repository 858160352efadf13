"""Embedding-level parity harness vs the reference TSN pipeline.

The reference's ground truth is its checked-in feature CSVs
(tests/data/features/...), produced by Caffe forwards of the UCF101 TSN
caffemodels (calcSig_wOF.py:30,173-176, calcSig_wOF_ensemble.sh:12-37).
The caffemodels and source videos are external artifacts; the day they are
available, this is the one command that closes the parity loop:

  python tools/parity_embeddings.py \
      --weights_dir /path/to/caffemodels \
      --videos  /path/to/videos \
      --fixtures tests/data/features/stock-video-clips_features \
      --splits 1 2 3

It (1) converts every caffemodel (V1 or modern layout) to npz, (2) runs the
extraction pipeline on each video at the reference geometry (340x256
resize, 25 ticks, 10s/15fps clips), (3) diffs per-clip embeddings against
the fixture CSVs and prints a per-(video, split, stream) tolerance report
(cosine + relative L2), plus top-k rank agreement.

--selftest runs the full loop on synthetic weights + a synthetic video
(no external artifacts) to prove the harness itself is green.

Expected caffemodel names (reference calcSig_wOF_ensemble.sh:12-37):
  ucf101_split{K}_tsn_rgb_reference_bn_inception.caffemodel
  ucf101_split{K}_tsn_flow_reference_bn_inception.caffemodel
(or any layout; override with --rgb_pattern/--flow_pattern).
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def convert_all(weights_dir, splits, rgb_pattern, flow_pattern, out_dir):
    from videoquery.nn import bn_inception
    from videoquery.nn.convert_caffe import convert, save_npz

    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for split in splits:
        for stream, pattern, cin in (
            ("rgb", rgb_pattern, bn_inception.RGB_CHANNELS),
            ("flow", flow_pattern, bn_inception.FLOW_CHANNELS),
        ):
            matches = glob.glob(os.path.join(
                weights_dir, pattern.format(split=split)))
            if not matches:
                raise SystemExit(
                    f"no caffemodel for split {split} stream {stream} "
                    f"(pattern {pattern!r} in {weights_dir})")
            npz = os.path.join(out_dir, f"{stream}_split{split}.npz")
            params = convert(matches[0], in_channels=cin)
            save_npz(params, npz)
            paths[(stream, split)] = npz
            print(f"[convert] {os.path.basename(matches[0])} -> {npz}")
    return paths


def extract_videos(videos, weights_dir, splits, out_dir):
    from videoquery.pipeline.extract import main as extract_main

    extract_main([videos, "--out", out_dir, "--weights", weights_dir,
                  "--splits", *map(str, splits)])


def compare_trees(got_root, fixture_root, top_k=10):
    """Per-CSV cosine/L2 report + rank agreement. Returns worst cosine."""
    from videoquery.index.csvio import read_feature_tree

    fixture = {}
    for video, split, csvf in read_feature_tree(fixture_root):
        for clip, vec in zip(csvf.clip_numbers, csvf.features):
            fixture[(video, split, csvf.stream, int(clip))] = vec
    got = {}
    for video, split, csvf in read_feature_tree(got_root):
        for clip, vec in zip(csvf.clip_numbers, csvf.features):
            got[(video, split, csvf.stream, int(clip))] = vec

    keys = sorted(set(fixture) & set(got))
    missing = len(set(fixture) - set(got))
    if not keys:
        raise SystemExit("no overlapping (video, split, stream, clip) rows "
                         "between extraction output and fixtures")
    if missing:
        print(f"[compare] WARNING: {missing} fixture rows missing from "
              "extraction output")
    by_group: dict[tuple, list] = {}
    for k in keys:
        a, b = fixture[k], got[k]
        cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))
        rel = float(np.linalg.norm(a - b) / (np.linalg.norm(a) + 1e-12))
        by_group.setdefault(k[:3], []).append((cos, rel))
    worst = 1.0
    print(f"{'video':32s} {'split':5s} {'stream':22s} "
          f"{'cos p50':>8s} {'cos min':>8s} {'relL2 p50':>9s}")
    for (video, split, stream), vals in sorted(by_group.items()):
        cs = np.array([v[0] for v in vals])
        rl = np.array([v[1] for v in vals])
        worst = min(worst, float(cs.min()))
        print(f"{video[:32]:32s} {split:<5d} {stream:22s} "
              f"{np.median(cs):8.4f} {cs.min():8.4f} {np.median(rl):9.4f}")
    return worst


def selftest():
    """Synthetic caffemodels -> convert -> extract a synthetic video ->
    reload CSVs: proves every stage of the harness without external
    artifacts (embeddings are compared against a second extraction pass,
    which must be bit-identical)."""
    import tempfile

    import jax  # noqa: F401  (fail early if no backend)

    sys.argv = [sys.argv[0]]
    from tests.test_nn import _layer  # reuse the wire-format writer
    from videoquery.nn import bn_inception

    rng = np.random.default_rng(0)
    tmp = tempfile.mkdtemp(prefix="vq_parity_selftest_")
    wdir = os.path.join(tmp, "caffemodels")
    os.makedirs(wdir)
    for split in (1,):
        for stream, cin in (("rgb", 3), ("flow", 10)):
            raw = b""
            for name, (kh, kw, ci, co) in bn_inception.conv_shapes(cin).items():
                w = rng.normal(size=(co, ci, kh, kw)).astype(np.float32) * 0.05
                b = rng.normal(size=(co,)).astype(np.float32) * 0.01
                raw += _layer(name, "Convolution", [w, b])
            raw += _layer("fc-action", "InnerProduct",
                          [rng.normal(size=(101, 1024)).astype(np.float32) * 0.01,
                           np.zeros(101, np.float32)])
            path = os.path.join(
                wdir, f"ucf101_split{split}_tsn_{stream}_reference_bn_inception.caffemodel")
            with open(path, "wb") as f:
                f.write(raw)
    npz_dir = os.path.join(tmp, "npz")
    convert_all(wdir, [1],
                "ucf101_split{split}_tsn_rgb_reference_bn_inception.caffemodel",
                "ucf101_split{split}_tsn_flow_reference_bn_inception.caffemodel",
                npz_dir)
    out_a = os.path.join(tmp, "out_a")
    out_b = os.path.join(tmp, "out_b")
    extract_videos("synthetic", npz_dir, [1], out_a)
    video = glob.glob(os.path.join(out_a, "*.mp4"))[0]
    extract_videos(video, npz_dir, [1], out_b)
    worst = compare_trees(out_b, out_a)
    assert worst > 0.999999, f"selftest: repeat extraction diverged ({worst})"
    print(f"[selftest] OK (worst repeat-extraction cosine {worst:.8f})")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--selftest", action="store_true")
    ap.add_argument("--weights_dir")
    ap.add_argument("--videos", help="video file or directory")
    ap.add_argument("--fixtures",
                    default="tests/data/features/stock-video-clips_features")
    ap.add_argument("--splits", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--rgb_pattern",
                    default="*split{split}*rgb*.caffemodel")
    ap.add_argument("--flow_pattern",
                    default="*split{split}*flow*.caffemodel")
    ap.add_argument("--out", default="parity_out")
    ap.add_argument("--min_cosine", type=float, default=0.98,
                    help="exit nonzero if any clip embedding falls below")
    args = ap.parse_args()

    from videoquery.core.jaxsetup import setup_jax

    setup_jax()
    if args.selftest:
        selftest()
        return
    if not (args.weights_dir and args.videos):
        raise SystemExit("--weights_dir and --videos are required "
                         "(or --selftest)")
    npz_dir = os.path.join(args.out, "npz")
    convert_all(args.weights_dir, args.splits, args.rgb_pattern,
                args.flow_pattern, npz_dir)
    csv_dir = os.path.join(args.out, "features")
    extract_videos(args.videos, npz_dir, args.splits, csv_dir)
    worst = compare_trees(csv_dir, args.fixtures)
    print(f"[parity] worst per-clip cosine vs fixtures: {worst:.4f} "
          f"(threshold {args.min_cosine})")
    if worst < args.min_cosine:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
