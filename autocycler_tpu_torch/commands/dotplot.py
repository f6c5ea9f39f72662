"""`autocycler dotplot`: all-vs-all k-mer dotplot PNG.

Parity target: reference dotplot.rs, and the JAX package's
commands/dotplot.py byte for byte — input may be an Autocycler GFA
(sequences reconstructed from paths), a FASTA file or a directory of
assemblies; layout constants, label auto-scaling with vertical left-side
text, lightgrey self-vs-self panels, mediumblue forward / firebrick reverse
dots, drawn in reverse-then-forward order so forward wins overlaps.

The k-mer matching runs on the device. The default sort-join groups all
windows of A (forward and reverse complement) and B with the k-mer grouping
kernels (ops.kmers) and joins on group id with torch ops. ``--grid-mode
device`` counts matches per tile with the word-compare kernel
(ops.dotplot_grid.match_grid) and refines only the nonzero tiles into exact
cells. Both give the JAX package's match arrays, element for element and in
its order, and the canvas is drawn on the device.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import UnitigGraph
from ..ops.dotplot_grid import match_grid, match_tile_cells, pack_2bit_words
from ..ops.encode import encode_both_strands
from ..ops.kmers import window_gids
from ..utils import (Spinner, find_all_assemblies, load_fasta, log,
                     quit_with_error)
from ..utils.knobs import knob_str

# layout constants (reference dotplot.rs:28-41)
INITIAL_TOP_LEFT_GAP = 0.1
BORDER_GAP = 0.015
BETWEEN_SEQ_GAP = 0.01
TOTAL_BETWEEN_SEQ_GAP = 0.1
TEXT_GAP = 0.0025
MAX_FONT_SIZE = 0.025
BACKGROUND = (255, 255, 255)
SELF_VS_SELF = (211, 211, 211)
SELF_VS_OTHER = (245, 245, 245)
TEXT_COLOUR = (0, 0, 0)
OUTLINE = (0, 0, 0)
FORWARD_DOT = (0, 0, 205)
REVERSE_DOT = (178, 34, 34)

# Matches = (fwd_i, fwd_j, rev_i, rev_j), int64 tensors on the device
Matches = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def dotplot(input_path, out_png, res: int = 2000, kmer: int = 32,
            grid_mode: str = "auto", device=None) -> None:
    if res < 500:
        quit_with_error("--res cannot be less than 500")
    if res > 10000:
        quit_with_error("--res cannot be greater than 10000")
    if kmer < 10:
        quit_with_error("--kmer cannot be less than 10")
    if kmer > 100:
        quit_with_error("--kmer cannot be greater than 100")
    if grid_mode not in ("auto", "host", "device"):
        quit_with_error("--grid-mode must be auto, host or device")
    dev = resolve_device(device)
    log.section_header("Starting autocycler dotplot")
    log.explanation("This command will take a unitig graph (either before or after "
                    "trimming) and generate a dotplot image containing all pairwise "
                    "comparisons of the sequences.")
    seqs = load_dotplot_sequences(input_path)
    with Spinner("creating dotplot..."):
        create_dotplot(seqs, out_png, res, kmer, grid_mode, dev)
    log.section_header("Finished!")
    log.message(f"Pairwise dotplots: {out_png}")
    log.message()


def load_dotplot_sequences(input_path) -> List[Tuple[Tuple[str, str], np.ndarray]]:
    """((filename, seqname), bytes) records from GFA / FASTA / directory
    (reference dotplot.rs:107-175)."""
    input_path = Path(input_path)
    records: List[Tuple[Tuple[str, str], np.ndarray]] = []
    if input_path.is_dir():
        for assembly in find_all_assemblies(input_path):
            for name, _header, seq in load_fasta(assembly):
                records.append(((assembly.name, name),
                                np.frombuffer(seq.encode(), dtype=np.uint8)))
        if not records:
            quit_with_error("no sequences were loaded")
        return records
    if not input_path.is_file():
        quit_with_error("--input is neither a file nor a directory")
    with open(input_path, "rb") as f:
        first_char = f.read(1).decode(errors="replace")
    if first_char == ">":
        for name, _header, seq in load_fasta(input_path):
            records.append(((input_path.name, name),
                            np.frombuffer(seq.encode(), dtype=np.uint8)))
    elif first_char in ("H", "S"):
        graph, sequences = UnitigGraph.from_gfa_file(input_path)
        reconstructed = graph.reconstruct_original_sequences(sequences)
        flat = []
        for filename, pairs in reconstructed.items():
            for header, seq in pairs:
                flat.append(((filename, header.split()[0]),
                             np.frombuffer(seq.encode(), dtype=np.uint8)))
        flat.sort(key=lambda r: r[0])
        records = flat
    else:
        quit_with_error("--input is neither GFA or FASTA")
    if not records:
        quit_with_error("no sequences were loaded")
    return records


def _between_seq_gap(gap: float, max_total_gap: float, seq_count: int) -> float:
    if seq_count <= 1:
        return gap
    if (seq_count - 1) * gap > max_total_gap:
        return max_total_gap / (seq_count - 1)
    return gap


def get_positions(seqs, res: int, kmer: int, top_left_gap: int, bottom_right_gap: int,
                  between_seq_gap: int):
    """Image start/end coordinate per sequence plus bp-per-pixel scale
    (reference dotplot.rs:224-267)."""
    names = [name for name, _ in seqs]
    seq_lengths = {name: max(0, len(seq) - kmer + 1) for name, seq in seqs}
    all_gaps = top_left_gap + bottom_right_gap + between_seq_gap * (len(seqs) - 1)
    pixels_for_sequence = max(0, res - all_gaps)
    if all_gaps > pixels_for_sequence and len(seqs) > 1:
        between_seq_gap = (res // 2 - top_left_gap - bottom_right_gap) // (len(seqs) - 1)
        all_gaps = top_left_gap + bottom_right_gap + between_seq_gap * (len(seqs) - 1)
        pixels_for_sequence = max(0, res - all_gaps)
    total = sum(seq_lengths.values())
    bp_per_pixel = total / pixels_for_sequence
    start_positions: Dict = {}
    end_positions: Dict = {}
    pos = top_left_gap
    for name in names:
        start_positions[name] = pos
        pos += round(seq_lengths[name] / bp_per_pixel)
        end_positions[name] = pos
        pos += between_seq_gap
    return start_positions, end_positions, bp_per_pixel


# --grid-mode auto uses the device grid from this many cells on; None means
# never, so auto is the sort-join (near-linear, where the grid is nA*nB)
DEVICE_GRID_MIN_CELLS = None

# Above this many grid cells a pair always uses the sort-join.
MAX_DEVICE_CELLS = 5e11

# Square tile of the device grid.
DEVICE_TILE = 2048


def _empty_matches(dev) -> Matches:
    z = torch.zeros(0, dtype=torch.int64, device=dev)
    return z, z, z, z


def _device_match_pair(a_words: torch.Tensor, b_words: torch.Tensor,
                       tile: int = DEVICE_TILE
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact (i, j) match positions from the coarse count grid: the
    word-compare kernel counts matches per tile, and only NONZERO tiles are
    refined into exact cells on the device (matches are sparse diagonals,
    so few tiles refine). Tile-padding cells past the ends are dropped (an
    all-T word equals the A-pad value, so edge-tile pad cells can match —
    the count kernel masks them by global index, the refinement by the
    same bound filter). Order: tiles row-major, then cells row-major within
    a tile, as the JAX package unpacks its tile bits."""
    tiles = match_grid(a_words, b_words, tile_a=tile, tile_b=tile)
    return match_tile_cells(a_words, b_words, torch.nonzero(tiles > 0),
                            tile_a=tile, tile_b=tile)


def kmer_match_positions_device(seq_a: np.ndarray, seq_b: np.ndarray,
                                kmer: int, enc_a=None, enc_b=None,
                                device=None) -> Optional[Matches]:
    """Device-grid variant of :func:`kmer_match_positions`, with the same
    contract and the JAX package's ``kmer_match_positions_device`` arrays.
    Returns None when inputs contain non-ACGT bytes (the 2-bit packing
    cannot represent them; the caller falls back to the sort-join) or the
    pair exceeds MAX_DEVICE_CELLS. ``enc_a``/``enc_b`` are optional
    precomputed encode_both_strands pairs."""
    dev = resolve_device(device)
    n_a = len(seq_a) - kmer + 1
    n_b = len(seq_b) - kmer + 1
    if n_a <= 0 or n_b <= 0:
        return _empty_matches(dev)
    if float(n_a) * float(n_b) > MAX_DEVICE_CELLS:
        return None
    codes_a, codes_rc = enc_a if enc_a is not None \
        else encode_both_strands(seq_a)
    codes_b = (enc_b if enc_b is not None
               else encode_both_strands(seq_b))[0]
    if (codes_a == 0).any() or (codes_b == 0).any():
        return None

    def words(codes):
        return torch.from_numpy(pack_2bit_words(codes, kmer)).to(dev)

    wb = words(codes_b)
    fwd_i, fwd_j = _device_match_pair(words(codes_a), wb)
    rc_i, rev_j = _device_match_pair(words(codes_rc), wb)
    rev_i = n_a - 1 - rc_i  # reference's reverse mapping (dotplot.rs:433-450)
    return fwd_i, fwd_j, rev_i, rev_j


def kmer_match_positions(seq_a: np.ndarray, seq_b: np.ndarray, kmer: int,
                         enc_a=None, enc_b=None, device=None) -> Matches:
    """All (i, j) k-mer matches of A-forward vs B and A-reverse vs B, with
    A-reverse positions mapped like the reference (n_a - i - 1,
    dotplot.rs:433-450). Returns (fwd_i, fwd_j, rev_i, rev_j) on the device.
    Every window is grouped by the k-mer grouping kernels; the join is a
    stable sort of A's group ids and a searchsorted of B's, so B positions
    ascend and, within one, A's windows keep their order."""
    dev = resolve_device(device)
    n_a = len(seq_a) - kmer + 1
    n_b = len(seq_b) - kmer + 1
    if n_a <= 0 or n_b <= 0:
        return _empty_matches(dev)
    if enc_a is None:
        enc_a = encode_both_strands(seq_a)
    if enc_b is None:
        enc_b = encode_both_strands(seq_b)
    codes = np.concatenate([enc_a[0], enc_a[1], enc_b[0]])
    starts = np.concatenate([
        np.arange(n_a, dtype=np.int64),
        len(seq_a) + np.arange(n_a, dtype=np.int64),
        2 * len(seq_a) + np.arange(n_b, dtype=np.int64)])
    gid = window_gids(codes, starts, kmer, dev)
    b_gid = gid[2 * n_a:]
    a_index = torch.arange(n_a, dtype=torch.int64, device=dev)
    b_index = torch.arange(n_b, dtype=torch.int64, device=dev)

    def join(a_gid, a_pos):
        sorted_gid, order_a = torch.sort(a_gid, stable=True)
        lo = torch.searchsorted(sorted_gid, b_gid)
        counts = torch.searchsorted(sorted_gid, b_gid, right=True) - lo
        total = int(counts.sum())
        j = torch.repeat_interleave(b_index, counts, output_size=total)
        first = torch.cumsum(counts, 0) - counts
        take = torch.repeat_interleave(lo - first, counts,
                                       output_size=total) \
            + torch.arange(total, device=dev)
        return a_pos[order_a][take], j

    fwd_i, fwd_j = join(gid[:n_a], a_index)
    rev_i, rev_j = join(gid[n_a:2 * n_a], n_a - 1 - a_index)
    return fwd_i, fwd_j, rev_i, rev_j


def create_dotplot(seqs, png_filename, res: int, kmer: int,
                   grid_mode: str = "auto", device=None) -> None:
    from PIL import Image, ImageDraw

    dev = resolve_device(device)
    log.section_header("Creating dotplot")
    log.explanation("K-mers common between sequences are now used to build the dotplot "
                    "image.")
    rf = float(res)
    top_left_gap = round(INITIAL_TOP_LEFT_GAP * rf)
    border_gap = max(2, round(BORDER_GAP * rf))
    between_gap = max(2, round(_between_seq_gap(BETWEEN_SEQ_GAP, TOTAL_BETWEEN_SEQ_GAP,
                                               len(seqs)) * rf))
    text_gap = max(1, round(TEXT_GAP * rf))
    max_font_size = max(1, round(MAX_FONT_SIZE * rf))

    font_path = _find_font()
    start_positions, end_positions, _ = get_positions(
        seqs, res, kmer, top_left_gap, border_gap, between_gap)
    text_height = _reduce_scale(seqs, start_positions, end_positions, font_path,
                                max_font_size)
    top_left_gap = int(2 * text_height) + border_gap
    start_positions, end_positions, bp_per_pixel = get_positions(
        seqs, res, kmer, top_left_gap, border_gap, between_gap)

    img = Image.new("RGB", (res, res), BACKGROUND)
    draw = ImageDraw.Draw(img)
    _draw_sequence_boxes(draw, seqs, start_positions, end_positions, fill=True)
    _draw_labels(img, seqs, start_positions, end_positions, text_gap, font_path,
                 text_height)

    canvas = torch.from_numpy(np.array(img)).to(dev)
    colours = {c: torch.tensor(c, dtype=torch.uint8, device=dev)
               for c in (REVERSE_DOT, FORWARD_DOT)}
    count = 0
    # one both-strand encoding per sequence, shared by every pair
    encs = [encode_both_strands(seq) for _, seq in seqs]
    for (name_a, seq_a), enc_a in zip(seqs, encs):
        for (name_b, seq_b), enc_b in zip(seqs, encs):
            use_device = grid_mode == "device" or (
                grid_mode == "auto" and DEVICE_GRID_MIN_CELLS is not None and
                max(0, len(seq_a) - kmer + 1) * max(0, len(seq_b) - kmer + 1)
                >= DEVICE_GRID_MIN_CELLS)
            matches = kmer_match_positions_device(seq_a, seq_b, kmer,
                                                  enc_a, enc_b, dev) \
                if use_device else None
            if matches is None:
                matches = kmer_match_positions(seq_a, seq_b, kmer,
                                               enc_a, enc_b, dev)
            fwd_i, fwd_j, rev_i, rev_j = matches
            a0, b0 = start_positions[name_a], start_positions[name_b]
            # reverse dots first so forward dots win overlaps, like the
            # reference's draw order (dotplot.rs:394-423)
            for ii, jj, colour in ((rev_i, rev_j, REVERSE_DOT),
                                   (fwd_i, fwd_j, FORWARD_DOT)):
                if not len(ii):
                    continue
                px = torch.round(ii.double() / bp_per_pixel).long() + a0
                py = torch.round(jj.double() / bp_per_pixel).long() + b0
                ok = (px >= 0) & (px < res) & (py >= 0) & (py < res)
                canvas[py[ok], px[ok]] = colours[colour]
            count += 1
    img = Image.fromarray(canvas.cpu().numpy())
    draw = ImageDraw.Draw(img)
    _draw_sequence_boxes(draw, seqs, start_positions, end_positions, fill=False)
    img.save(png_filename)
    log.message(f"{count} pairwise dotplot{'' if count == 1 else 's'} drawn to image")
    log.message()


def _find_font():
    """Scalable label font, checked in order (reference dotplot.rs:26
    embeds DejaVuSans; this package bundles the same free font so labels
    always scale):
    1. AUTOCYCLER_DOTPLOT_FONT (any .ttf/.otf path),
    2. the bundled DejaVuSans (autocycler_tpu_torch/assets/),
    3. matplotlib's bundled DejaVuSans,
    4. standard fontconfig directories (DejaVu/Liberation/Noto/FreeSans),
    5. `fc-match` if fontconfig's CLI is available.
    Falls back to PIL's bitmap font with a stderr note (labels then cannot
    scale)."""
    override = knob_str("AUTOCYCLER_DOTPLOT_FONT")
    if override:
        if Path(override).is_file():
            return override
        print(f"autocycler: AUTOCYCLER_DOTPLOT_FONT={override} not found; "
              "continuing with discovery", file=sys.stderr)
    bundled = Path(__file__).resolve().parent.parent / "assets" / "DejaVuSans.ttf"
    if bundled.is_file():
        return str(bundled)
    try:
        import matplotlib
        path = Path(matplotlib.get_data_path()) / "fonts" / "ttf" / "DejaVuSans.ttf"
        if path.is_file():
            return str(path)
    except Exception:
        pass
    for candidate in (
            "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
            "/usr/share/fonts/dejavu/DejaVuSans.ttf",
            "/usr/share/fonts/TTF/DejaVuSans.ttf",
            "/usr/share/fonts/truetype/liberation/LiberationSans-Regular.ttf",
            "/usr/share/fonts/truetype/noto/NotoSans-Regular.ttf",
            "/usr/share/fonts/truetype/freefont/FreeSans.ttf",
            "/System/Library/Fonts/Helvetica.ttc",
            "C:/Windows/Fonts/arial.ttf"):
        if Path(candidate).is_file():
            return candidate
    try:
        import subprocess
        out = subprocess.run(["fc-match", "-f", "%{file}", "sans"],
                             capture_output=True, text=True, timeout=10)
        path = out.stdout.strip()
        if out.returncode == 0 and path and Path(path).is_file():
            return path
    except Exception:
        pass
    print("autocycler: no scalable font found — dotplot labels will use "
          "PIL's fixed-size bitmap font (set AUTOCYCLER_DOTPLOT_FONT to fix)",
          file=sys.stderr)
    return None


def _text_width(text: str, font_path, size: float) -> float:
    from PIL import ImageFont
    if font_path is None or size < 1:
        return len(text) * size * 0.6
    font = ImageFont.truetype(font_path, max(1, int(size)))
    return font.getlength(text)


def _reduce_scale(seqs, start_positions, end_positions, font_path,
                  max_font_size: int) -> float:
    """Shrink the font until every label fits its panel width
    (reference dotplot.rs:308-328)."""
    text_height = float(max_font_size)
    for (filename, seqname), _ in seqs:
        name = (filename, seqname)
        available = float(end_positions[name] - start_positions[name])
        width = max(_text_width(filename, font_path, text_height),
                    _text_width(seqname, font_path, text_height))
        if width > available and width > 0:
            text_height *= available / width
    return text_height


def _draw_sequence_boxes(draw, seqs, start_positions, end_positions, fill: bool) -> None:
    for name_a, _ in seqs:
        sa, ea = start_positions[name_a] - 1, end_positions[name_a] + 1
        for name_b, _ in seqs:
            sb, eb = start_positions[name_b] - 1, end_positions[name_b] + 1
            if fill:
                colour = SELF_VS_SELF if name_a == name_b else SELF_VS_OTHER
                draw.rectangle([sa, sb, ea, eb], fill=colour, outline=OUTLINE)
            else:
                draw.rectangle([sa, sb, ea, eb], outline=OUTLINE)


def _draw_labels(img, seqs, start_positions, end_positions, text_gap: int, font_path,
                 text_height: float) -> None:
    from PIL import Image, ImageDraw, ImageFont
    if font_path is None or text_height < 1:
        return
    font = ImageFont.truetype(font_path, max(1, int(text_height)))
    draw = ImageDraw.Draw(img)
    min_pos = min(start_positions.values())
    h = int(text_height)
    for (filename, seqname), _ in seqs:
        name = (filename, seqname)
        start, end = start_positions[name], end_positions[name]
        pos_1 = min_pos - text_gap - h
        pos_2 = pos_1 - h
        draw.text((start, pos_1), seqname, fill=TEXT_COLOUR, font=font)
        draw.text((start, pos_2), filename, fill=TEXT_COLOUR, font=font)
        # vertical labels on the left side, rotated 90° counterclockwise
        for text, x in ((seqname, pos_1), (filename, pos_2)):
            w = int(_text_width(text, font_path, text_height)) + 1
            tmp = Image.new("RGB", (w, h + 2), BACKGROUND)
            ImageDraw.Draw(tmp).text((0, 0), text, fill=TEXT_COLOUR, font=font)
            rotated = tmp.rotate(90, expand=True)
            mask = Image.eval(rotated.convert("L"), lambda v: 255 if v < 250 else 0)
            img.paste(rotated, (x, end - rotated.height), mask)
