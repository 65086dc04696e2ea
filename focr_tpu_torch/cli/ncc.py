"""ncc CLI on PyTorch + CUDA — the flags and output of focr_tpu/cli/ncc.py
(reference ncc.rs:486-542, 788-878), plus --device and --needle-bank.

stdout: decoded text lines (or --csv rows, or --raw hit dumps); stderr: all
diagnostics. --rust routes to the host differential oracle, exactly like the
reference's flag switches between the C and Rust kernels; --engine native runs
the C++ host search (native/ncc_cpu.py). --device-kernel and --wire are
accepted and unused (one kernel, no wire codec).

Pages are read as focr reads them (io/images.py::load_gray_many_isolated, or
load_gray_many under --strict): a raw 8-bit P5 page is mapped read-only, the
rest read on a pool. The call's stages are named spans (ncc_bank_load,
ncc_matcher_build, ncc_page_read, ncc_print; the search's own in
models/ncc.py), its counters are zeroed at the start of main() and
--metrics-json reports them.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from focr_tpu_torch.fonts.ft import Face, HintingOptions
from focr_tpu_torch.models.types import BoxSize, NCC_DEFAULT_ALPHABET, RenderOptions


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ncc", description="NCC template-matching OCR (PyTorch + CUDA)"
    )
    p.add_argument("-i", "--img", action="extend", nargs="+", default=[], required=True)
    p.add_argument("-f", "--font", required=True)
    p.add_argument("-t", "--text-size", type=float, required=True)
    p.add_argument("--x-bits", type=int, default=0)
    p.add_argument("--y-bits", type=int, default=0)
    p.add_argument("--hinting", action="store_true")
    p.add_argument("--threshold", type=float, default=0.8)
    p.add_argument("--anchor-threshold", type=float, default=0.95)
    p.add_argument("--overlap", type=int, default=5)
    p.add_argument("-a", "--alphabet", default=NCC_DEFAULT_ALPHABET)
    p.add_argument("--box-size", default="alphabet")
    p.add_argument("--x-padding", type=int, default=0)
    p.add_argument("--y-padding", type=int, default=0)
    p.add_argument("--save-letters", action="store_true")
    p.add_argument("--rust", action="store_true",
                   help="use the host differential-oracle kernel instead of the device path")
    p.add_argument("--engine", choices=["device", "native", "oracle"], default=None,
                   help="execution tier: device (CUDA card, default), native (C++ "
                        "host), oracle (NumPy reference). --rust is an alias for "
                        "oracle.")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the device engine: cuda (the CUDA kernels; "
                        "default) or cpu (their plain PyTorch versions); the "
                        "native and oracle engines run on the host")
    p.add_argument("--needle-bank", default=None, metavar="NPZ",
                   help="load the needles from a saved bank "
                        "(fonts/bank.py::save_needle_bank) instead of rendering "
                        "them with FreeType; its settings must match the flags")
    p.add_argument("--device-kernel", choices=["auto", "xla", "pallas"], default="auto",
                   help="accepted for command-line compatibility with focr_tpu and "
                        "otherwise unused: this package has one device kernel")
    p.add_argument("--wire", choices=["delta", "pos"], default=None,
                   help="accepted for command-line compatibility with focr_tpu and "
                        "otherwise unused: this package has no wire codec, candidate "
                        "positions come back as they are")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--verbose-sync", action="store_true",
                   help="verbose with MEASURED per-search timing: fences the device "
                        "after each size group's dispatch so elapsed/ns-per-pixel are "
                        "wall-clock measurements like the reference's "
                        "(ncc.rs:657-666); slower — the pipelined default prints "
                        "estimates instead")
    p.add_argument("--csv", action="store_true")
    p.add_argument("--raw", action="store_true")
    p.add_argument("--mesh", choices=["auto", "off"], default="auto",
                   help="shard page batches over all visible cards (auto: on when >1 "
                        "card; single-card runs are unaffected)")
    p.add_argument("--strict", action="store_true",
                   help="fail on the first unreadable page (reference panic semantics); "
                        "default isolates per-page errors to stderr and continues")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the search to DIR")
    p.add_argument("--metrics-json", default=None, metavar="PATH",
                   help="write structured run metrics (JSON) to PATH ('-' = stderr)")
    return p


def _verbose_metrics(face: Face, alphabet: str, text_size: float) -> None:
    """Font metrics dump (ncc.rs:791-831)."""
    m = face.metrics
    to_px = (1.0 / m.units_per_em) * text_size
    line_space = m.ascent - m.descent + m.line_gap
    print(
        f"metrics Metrics {{ units_per_em: {m.units_per_em}, ascent: {m.ascent}, "
        f"descent: {m.descent}, line_gap: {m.line_gap}, "
        f"bounding_box: {m.bounding_box} }}",
        file=sys.stderr,
    )
    print(f"ascent  {m.ascent * to_px}px", file=sys.stderr)
    print(f"descent {m.descent * to_px}px", file=sys.stderr)
    bb = m.bounding_box
    print(f"font_bbox size ({bb.width * to_px}, {bb.height * to_px})px", file=sys.stderr)
    print(f"line_space {line_space} {line_space * to_px}px", file=sys.stderr)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.verbose_sync:
        args.verbose = True
    from focr_tpu_torch.utils.device import resolve_device
    from focr_tpu_torch.utils.metrics import profiling, reset_counters

    reset_counters("ncc_candidates", "ncc_hits", "ncc_host_waits", "ncc_post_ns",
                   "ncc_post_native", "pages_mapped", "pages_decoded")

    hinting = HintingOptions(full=True, size=args.text_size) if args.hinting else HintingOptions()
    ropts = RenderOptions(size=args.text_size, hinting=hinting)
    box = BoxSize.parse(args.box_size)
    engine = args.engine or ("oracle" if args.rust else "device")
    try:
        device = resolve_device(args.device) if engine == "device" else torch.device("cpu")
    except RuntimeError as e:
        print(f"ncc: error: {e}", file=sys.stderr)
        return 2

    # the operator's trace (--profile) holds the whole call: bank load to last line
    with profiling(args.profile, device.type == "cuda"):
        return _run(args, engine, device, ropts, box)


def _run(args, engine: str, device: torch.device, ropts: RenderOptions, box: BoxSize) -> int:
    from focr_tpu_torch.fonts.bank import bank_settings, load_needle_bank
    from focr_tpu_torch.io.images import (
        load_gray, load_gray_many, load_gray_many_isolated, save_gray,
    )
    from focr_tpu_torch.models.ncc import NccMatcher, _f32
    from focr_tpu_torch.models.post import (
        process_hits, process_hits_struct, process_hits_text,
    )
    from focr_tpu_torch.utils.metrics import COUNTERS, metrics_run, span, write_metrics

    needles = None
    if args.needle_bank is not None:
        with span("ncc_bank_load"):
            needles, saved = load_needle_bank(args.needle_bank)
            want = bank_settings(args.font, args.alphabet, ropts, box, args.x_bits,
                                 args.y_bits, (args.x_padding, args.y_padding))
            if saved != want:
                print(f"ncc: error: {args.needle_bank} was rendered with {saved}, "
                      f"the flags ask for {want}", file=sys.stderr)
                return 2
    # the font itself is opened only when something needs FreeType
    need_face = needles is None or args.raw or args.save_letters
    face = Face(args.font) if need_face else None
    if args.verbose:
        if face is None:
            # a saved bank holds no font metrics: with no FreeType or no font
            # file the dump is left out, and stderr says so
            try:
                face = Face(args.font)
            except OSError as e:
                print(f"ncc: font metrics not shown: {e}", file=sys.stderr)
        if face is not None:
            _verbose_metrics(face, args.alphabet, args.text_size)

    with span("ncc_matcher_build"):
        matcher = NccMatcher(
            face,
            args.alphabet,
            ropts,
            box_size=box,
            x_bits=args.x_bits,
            y_bits=args.y_bits,
            padding=(args.x_padding, args.y_padding),
            threshold=args.threshold,
            device=device,
            needles=needles,
        )

    if args.save_letters:
        os.makedirs("letters", exist_ok=True)
        for nd in matcher.needles:
            x = int(nd.offset[0] * 1000.0)
            y = int(nd.offset[1] * 1000.0)
            # the reference dumps the RAW white-on-black canvas: canvas_to_lum8
            # (ncc.rs:645 -> ncc.rs:917-923) copies pixels without inverting
            save_gray(f"letters/{nd.letter}-{x}_{y}.png", nd.pixels)

    get = {
        "device": matcher.get_hits,
        "native": matcher.get_hits_native,
        "oracle": matcher.get_hits_oracle,
    }[engine]
    if args.raw:
        assert len(args.img) == 1
        with span("ncc_page_read"):
            page = load_gray(args.img[0])
        if engine == "device":
            get(page, verbose=args.verbose, raw=True, out=sys.stdout, sync=args.verbose_sync)
        else:
            get(page, verbose=args.verbose, raw=True, out=sys.stdout)
        return 0

    # raw 8-bit gray pages are mapped read-only (nothing downstream writes into
    # a page), the rest read on a pool; a bad page keeps its place in the output
    with span("ncc_page_read"):
        if args.strict:
            read = load_gray_many(args.img)
            errors: list[tuple[int, str]] = []
        else:
            read, errors = load_gray_many_isolated(args.img)
    for i, err in errors:
        print(f"ERROR {args.img[i]}: {err}", file=sys.stderr)
    loaded = [(i, p) for i, p in enumerate(read) if p is not None]

    # the array-form (struct) pipeline skips per-hit object creation; verbose
    # diagnostics need the object form (per-hit dumps). Text output fuses
    # post-processing into the pipeline's collect tasks (the reference's rayon
    # (get_hits, process_hits) task shape, ncc.rs:842-845); --csv needs full
    # per-hit fields, so it post-processes to objects.
    mesh = None
    if args.mesh == "auto" and engine == "device":
        from focr_tpu_torch.parallel.mesh import auto_mesh

        mesh = auto_mesh(device)

    struct = engine == "device" and not args.verbose
    text_post = None
    if struct and not args.csv:
        text_post = lambda hs: process_hits_text(  # noqa: E731
            hs, args.anchor_threshold, args.overlap)
    pages = [p for _, p in loaded]
    with metrics_run() as mrun:
        if engine == "device" and args.verbose_sync:
            # measurement mode: per-page fenced dispatch, no pipeline and no
            # sharding, so the stderr timing lines are wall-clock truth
            hit_lists = [matcher.get_hits(p, verbose=True, sync=True) for p in pages]
        elif engine == "device" and mesh is not None and len(pages) > 1:
            # several slots: same-shape page buckets dealt over the mesh
            hit_lists = [None] * len(pages)
            buckets: dict[tuple[int, int], list[int]] = {}
            for j, p in enumerate(pages):
                buckets.setdefault(p.shape, []).append(j)
            for idxs in buckets.values():
                outs = matcher.get_hits_many_sharded(
                    [pages[j] for j in idxs], mesh, verbose=args.verbose, struct=struct,
                    post=text_post,
                )
                for j, h in zip(idxs, outs):
                    hit_lists[j] = h
        elif engine == "device":
            hit_lists = matcher.get_hits_many(
                pages, verbose=args.verbose, struct=struct, post=text_post)
        else:
            hit_lists = [get(p, verbose=args.verbose) for p in pages]
        if struct and not args.csv:
            hit_lines = hit_lists
        elif struct:
            hit_lines = [
                process_hits_struct(h, args.anchor_threshold, args.overlap) for h in hit_lists
            ]
        else:
            hit_lines = [
                process_hits(h, args.anchor_threshold, args.overlap, verbose=args.verbose)
                for h in hit_lists
            ]
    lines_by_page = {i: h for (i, _), h in zip(loaded, hit_lines)}
    pages_out = [(i, lines_by_page.get(i, [])) for i in range(len(args.img))]

    with span("ncc_print"):
        if args.csv:
            for i, lines in pages_out:
                for line in lines:
                    for m in line:
                        cx, cy = m.center
                        print(
                            f"{i},{ord(m.letter)},{_f32(cx)},{_f32(cy)},{m.x},{m.y},{m.w},{m.h}"
                        )
        else:
            for _, lines in pages_out:
                for line in lines:
                    print(line if isinstance(line, str) else "".join(m.letter for m in line))

    if args.metrics_json is not None:
        write_metrics(
            args.metrics_json,
            tool="ncc",
            pages=len(args.img),
            decoded_pages=len(args.img) - len(errors),
            lines=sum(len(ls) for _, ls in pages_out),
            hits=sum(len(m) for _, ls in pages_out for m in ls),
            errors=[{"page": args.img[i], "error": e} for i, e in errors],
            search_seconds=mrun.seconds,
            engine=engine,
            counters=dict(COUNTERS),
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
