"""focr CLI on PyTorch + CUDA — the flags and output of focr_tpu/cli/focr.py
(reference main.rs:342-508), plus --device and --grid-bank.

stdout carries ONLY decoded text lines; every diagnostic goes to stderr (the
contract that makes `focr ... | sed | base64 -d` work). An unreadable page is
reported as `ERROR <path>: ...` on stderr and skipped, unless --strict.
"""

from __future__ import annotations

import argparse
import os
import sys

from focr_tpu_torch.fonts.ft import Face, HintingOptions
from focr_tpu_torch.models.types import DecodeOptions, FOCR_DEFAULT_ALPHABET, RenderOptions


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="focr", description="grid SSD font OCR (PyTorch + CUDA)")
    p.add_argument("-i", "--img", action="extend", nargs="+", default=[], required=True)
    p.add_argument("-f", "--font", required=True)
    p.add_argument("-a", "--alphabet", default=FOCR_DEFAULT_ALPHABET)
    p.add_argument("--hinting", action="store_true")
    p.add_argument("-t", "--text-size", type=float, required=True)
    p.add_argument("-k", "--kerning", type=float, default=1.0)
    p.add_argument("-x", type=int, default=0)
    p.add_argument("-y", type=int, default=0)
    p.add_argument("-w", "--width", type=int, required=True)
    p.add_argument("--line-height", type=int, required=True)
    p.add_argument("--line-advance", type=int, required=True)
    p.add_argument("--test", default=None, metavar="PREFIX",
                   help="write <prefix>-rect.png and <prefix>-text.png, then exit")
    p.add_argument("--verify", default=None, metavar="DIR",
                   help="dir for verify images. Red is reference, Blue is rendered")
    p.add_argument("--batch-size", type=int, default=16, help="pages per device batch")
    p.add_argument("--mesh", choices=["auto", "off"], default="auto",
                   help="shard page batches over all visible cards (auto: on when >1 "
                        "card; single-card runs are unaffected)")
    p.add_argument("--glyph-shards", type=int, default=1,
                   help="tensor-parallel shards of the glyph template bank (must divide "
                        "the slot count over all processes; any number)")
    p.add_argument("--strict", action="store_true",
                   help="fail on the first unreadable page (reference panic semantics); "
                        "default isolates per-page errors to stderr and continues")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the call, from the bank load "
                        "to the last line, to DIR")
    p.add_argument("--metrics-json", default=None, metavar="PATH",
                   help="write structured run metrics (JSON) to PATH ('-' = stderr)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (the CUDA kernel; default) or cpu (its plain PyTorch version)")
    p.add_argument("--grid-bank", default=None, metavar="NPZ",
                   help="load the glyph templates from a saved focr bank set, grid "
                        "(monospace) or proportional (fonts/bank.py::save_grid_bank), "
                        "instead of rendering them with FreeType; its settings must "
                        "match the flags")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from focr_tpu_torch.fonts.bank import grid_bank_settings, load_grid_bank
    from focr_tpu_torch.io.images import (
        load_gray, load_gray_many, load_gray_many_isolated, save_rgb, save_rgba,
    )
    from focr_tpu_torch.models.focr import GridDecoder, decode_pages, decode_single_chunks
    from focr_tpu_torch.utils.device import resolve_device
    from focr_tpu_torch.utils.metrics import (
        COUNTERS, metrics_run, profiling, reset_counters, span, write_metrics,
    )

    reset_counters("bank_bytes_loaded", "strip_bytes_uploaded", "bank_cache_hits",
                   "bank_cache_misses", "prop_lines_scanned", "prop_steps", "prop_strips_white",
                   "pages_mapped", "pages_decoded")
    if args.verify is not None:
        assert os.path.isdir(args.verify), "--verify should be a dir"

    hinting = HintingOptions(full=True, size=args.text_size) if args.hinting else HintingOptions()
    ropts = RenderOptions(size=args.text_size, hinting=hinting, kern_x=args.kerning)
    dopts = DecodeOptions(
        x_start=args.x,
        y_start=args.y,
        width=args.width,
        line_height=args.line_height,
        line_advance=args.line_advance,
    )

    if args.test is not None:
        # host-side drawing with FreeType: no device, no bank
        from focr_tpu_torch.io.overlays import draw_test_rectangles, draw_test_text

        img = load_gray(args.img[0])
        save_rgba(f"{args.test}-rect.png", draw_test_rectangles(img, dopts))
        face = Face(args.font)
        save_rgba(f"{args.test}-text.png", draw_test_text(face, args.alphabet, img, ropts))
        return 0

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"focr: error: {e}", file=sys.stderr)
        return 2

    # the operator's trace (--profile) holds the whole call: bank load to last line
    with profiling(args.profile, device.type == "cuda"):
        banks = None
        if args.grid_bank is not None:
            with span("focr_bank_open"):
                banks, saved = load_grid_bank(args.grid_bank)
                want = grid_bank_settings(args.font, args.alphabet, ropts, args.width,
                                          saved["kind"])
                if saved != want:
                    print(f"focr: error: {args.grid_bank} was rendered with {saved}, "
                          f"the flags ask for {want}", file=sys.stderr)
                    return 2
                missing = sorted(set(range(1, args.line_height + 1)) - set(banks))
                if missing:
                    print(f"focr: error: {args.grid_bank} has no bank for crop heights {missing}",
                          file=sys.stderr)
                    return 2
        # the font itself is opened only when something renders with FreeType: the
        # banks, without a saved set, and --verify's overlay
        face = Face(args.font) if banks is None or args.verify is not None else None

        with span("focr_page_read"):
            if args.strict:
                pages = load_gray_many(args.img)
                errors: list[tuple[int, str]] = []
            else:
                pages, errors = load_gray_many_isolated(args.img)
        for i, err in errors:
            print(f"ERROR {args.img[i]}: {err}", file=sys.stderr)

        good_idx = [i for i, p in enumerate(pages) if p is not None]
        good_pages = [pages[i] for i in good_idx]
        mesh = None
        if args.mesh == "auto":
            from focr_tpu_torch.parallel.mesh import auto_mesh

            mesh = auto_mesh(device, glyph_shards=args.glyph_shards)

        streamed = len(args.img) == 1 and args.verify is None and bool(good_pages)
        results: list[list] = [[] for _ in pages]
        if streamed:
            # single-image fast path: print each line as soon as its row chunk
            # is decoded (main.rs:427-440)
            page = good_pages[0]
            dec = GridDecoder(face, args.alphabet, dopts, ropts, page.shape, device,
                              banks=banks, mesh=mesh)
            with metrics_run() as mrun:
                for lines in decode_single_chunks(dec, page):
                    with span("focr_print"):
                        for line in lines:
                            print(line.text, flush=True)
                    results[good_idx[0]].extend(lines)
        else:
            with metrics_run() as mrun:
                good_results = decode_pages(
                    good_pages, face, args.alphabet, dopts, ropts, device,
                    batch_size=args.batch_size, banks=banks, mesh=mesh,
                )
            for i, lines in zip(good_idx, good_results):
                results[i] = lines

        if args.verify is not None:
            from focr_tpu_torch.io.overlays import draw_verify, red_blue_mse

            for img_path, page, lines in zip(args.img, pages, results):
                if page is None:
                    continue
                overlay = draw_verify(page, lines, face, dopts, ropts)
                stem = os.path.splitext(os.path.basename(img_path))[0] + ".png"
                save_rgb(os.path.join(args.verify, stem), overlay)
                diff = red_blue_mse(overlay)
                print(f"{img_path} {diff:.6f}", file=sys.stderr)

        if not streamed:
            with span("focr_print"):
                for lines in results:
                    for line in lines:
                        print(line.text)

    if args.metrics_json is not None:
        write_metrics(
            args.metrics_json,
            tool="focr",
            pages=len(pages),
            decoded_pages=len(good_idx),
            lines=sum(len(r) for r in results),
            errors=[{"page": args.img[i], "error": e} for i, e in errors],
            decode_seconds=mrun.seconds,
            pages_per_sec=(len(good_idx) / mrun.seconds) if mrun.seconds else None,
            counters=dict(COUNTERS),
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
