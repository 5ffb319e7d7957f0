"""ckpt_fsck: verify / inspect a cxxnet_tpu_torch model directory offline.

The port's twin of tools/ckpt_fsck.py, on the port's utils/checkpoint.py
and utils/serializer.py (the model files of both packages are one format).
It adds ``--conf``: the deep parse of a net with pooling layers needs the
config the model was trained with (a model file does not carry a pooling
layer's size), which the JAX tool cannot be given.
Checks every checkpoint's integrity framing (header magic, CRC32 footer,
length) without building the net, reports the training
cursor recorded in each file's state section, and flags stale ``.tmp``
leftovers and quarantined ``.corrupt`` files. Exit status 0 when every
checkpoint verifies, 1 when any is corrupt — wire it into CI or run it
before resuming a long job on a suspect filesystem.

Usage:
    python -m cxxnet_tpu_torch.tools.ckpt_fsck <model_dir | file.model> [...]
    python -m cxxnet_tpu_torch.tools.ckpt_fsck --deep models/  # also load
    python -m cxxnet_tpu_torch.tools.ckpt_fsck --deep --conf net.conf models/
    python -m cxxnet_tpu_torch.tools.ckpt_fsck --quarantine models/
    python -m cxxnet_tpu_torch.tools.ckpt_fsck --selftest

Classification per file:
    OK       framed (CXCKHDR1 + CRC32 footer), integrity verified
    LEGACY   footer-less seed/reference-format file — readable but
             unverifiable; rewrite it by resuming + saving once
    CORRUPT  framing present but inconsistent (truncated, torn write,
             bit flip) — the trainer will quarantine it, never load it
"""

from __future__ import annotations

import argparse
import json
import os
import struct
import sys
import tempfile

from ..utils import checkpoint as ckpt
from ..utils import serializer
from ..utils.config import parse_config_file


def inspect_file(path: str, deep: bool = False, conf=None) -> dict:
    """Classify one checkpoint file; returns a report dict. ``conf``, the
    (key, value) pairs of the config the model was trained with, is given
    to the net before a deep parse, as the command line gives it: a model
    file does not carry every layer setting (a pooling layer's size comes
    from the config), so a deep parse of such a net needs it."""
    rep = {"path": path, "size": None, "status": "corrupt", "reason": "",
           "net_type": None, "state": None}
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        rep["reason"] = "unreadable: %s" % e
        return rep
    rep["size"] = len(blob)
    status, reason, payload = ckpt.verify_blob(blob)
    rep["status"], rep["reason"] = status, reason
    if payload is None:
        return rep
    if len(payload) >= 4:
        (net_type,) = struct.unpack("<i", payload[:4])
        rep["net_type"] = net_type
        if not 0 <= net_type < 1024:
            rep["status"] = "corrupt"
            rep["reason"] = "implausible net_type %d" % net_type
            return rep
    else:
        rep["status"] = "corrupt"
        rep["reason"] = "payload shorter than the net_type header"
        return rep
    st = ckpt.peek_state(payload)
    if st is not None:
        rep["state"] = {k: st[k] for k in
                        ("start_counter", "batches_done", "rng_counter")
                        if k in st}
    if deep and rep["status"] in ("ok", "legacy"):
        # full structural parse through the port's net on the CPU
        # (catches in-payload damage that CRC can't see on legacy files)
        try:
            from ..nnet.trainer import create_net
            r = serializer.Reader(payload)
            net_type = r.read_int32()
            net = create_net(net_type)
            for k, v in conf or ():
                net.set_param(k, v)
            net.set_param("dev", "cpu")
            net.load_model(r)
            net.load_training_state(r)
        except Exception as e:
            rep["status"] = "corrupt"
            rep["reason"] = "deep parse failed: %s" % e
    return rep


def collect(paths):
    """Expand dir args into (checkpoints, stale tmp files, quarantined)."""
    files, tmps, corrupts = [], [], []
    for p in paths:
        if os.path.isdir(p):
            for nm in sorted(os.listdir(p)):
                full = os.path.join(p, nm)
                if nm.endswith(".tmp"):
                    tmps.append(full)
                elif ".corrupt" in nm:
                    corrupts.append(full)
                elif nm.endswith(".model"):
                    files.append(full)
        else:
            files.append(p)
    return files, tmps, corrupts


def selftest() -> int:
    """Prove the verifier flags every injected corruption: valid file ok,
    truncation / bit flip / torn footer corrupt, legacy recognized, stale
    tmp reported."""
    fails = []

    def expect(name, got, want):
        if got != want:
            fails.append("%s: classified %r, expected %r" % (name, got, want))

    with tempfile.TemporaryDirectory() as d:
        w = serializer.Writer()
        w.write_int32(0)
        w.write_string("ckpt_fsck selftest payload")
        w.write_tensor(__import__("numpy").arange(64, dtype="f4"))
        payload = w.getvalue()

        valid = os.path.join(d, "0001.model")
        ckpt.write_checkpoint(valid, payload)
        expect("valid", inspect_file(valid)["status"], "ok")

        blob = open(valid, "rb").read()
        trunc = os.path.join(d, "0002.model")
        open(trunc, "wb").write(blob[: len(blob) // 2])
        expect("truncated", inspect_file(trunc)["status"], "corrupt")

        flip = os.path.join(d, "0003.model")
        fb = bytearray(blob)
        fb[len(fb) // 2] ^= 0x40
        open(flip, "wb").write(bytes(fb))
        expect("bit-flip", inspect_file(flip)["status"], "corrupt")

        torn = os.path.join(d, "0004.model")
        open(torn, "wb").write(blob[:-1])   # footer magic torn off
        expect("torn-footer", inspect_file(torn)["status"], "corrupt")

        legacy = os.path.join(d, "0005.model")
        open(legacy, "wb").write(payload)   # no framing at all
        expect("legacy", inspect_file(legacy)["status"], "legacy")

        stale = os.path.join(d, "0006.model.tmp")
        open(stale, "wb").write(blob[:10])
        _, tmps, _ = collect([d])
        expect("stale-tmp", [os.path.basename(t) for t in tmps],
               ["0006.model.tmp"])

        # the directory checker reflects the injected corruption in rc
        rc = main([d])
        expect("dir-exit-code", rc, 1)

    if fails:
        for f in fails:
            print("SELFTEST FAIL: %s" % f)
        return 1
    print("ckpt_fsck selftest: all corruption classes detected")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", help="model dirs or files")
    ap.add_argument("--deep", action="store_true",
                    help="fully parse each checkpoint (loads the net "
                         "on the CPU)")
    ap.add_argument("--conf", default=None,
                    help="the config file the models were trained with, "
                         "for --deep (the layer settings a model file "
                         "does not carry)")
    ap.add_argument("--quarantine", action="store_true",
                    help="rename corrupt files to <name>.corrupt")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("--selftest", action="store_true",
                    help="verify the verifier against injected corruption")
    args = ap.parse_args(argv)
    if args.selftest:
        return selftest()
    if not args.paths:
        ap.error("no model dir or file given")
    files, tmps, corrupts = collect(args.paths)
    conf = parse_config_file(args.conf) if args.conf else None
    reports = [inspect_file(p, deep=args.deep, conf=conf) for p in files]
    n_bad = sum(r["status"] == "corrupt" for r in reports)
    if args.quarantine:
        for r in reports:
            if r["status"] == "corrupt":
                r["quarantined_to"] = ckpt.quarantine(r["path"], r["reason"])
    if args.as_json:
        print(json.dumps({"checkpoints": reports, "stale_tmp": tmps,
                          "quarantined": corrupts}, indent=2))
    else:
        for r in reports:
            st = r["state"] or {}
            cursor = (" round=%s batch=%s" % (st.get("start_counter", "?"),
                                              st.get("batches_done", "?"))
                      if st else "")
            print("%-8s %10s bytes  %s%s%s" %
                  (r["status"].upper(), r["size"], r["path"], cursor,
                   ("  [%s]" % r["reason"]) if r["reason"] else ""))
        for t in tmps:
            print("STALE    %10s bytes  %s  [leftover tmp from a killed "
                  "write]" % (os.path.getsize(t), t))
        for c in corrupts:
            print("QUARANT  %10s bytes  %s" % (os.path.getsize(c), c))
        print("%d checkpoint(s): %d ok, %d legacy, %d corrupt, "
              "%d stale tmp" %
              (len(reports),
               sum(r["status"] == "ok" for r in reports),
               sum(r["status"] == "legacy" for r in reports),
               n_bad, len(tmps)))
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
