"""A small baseline JPEG writer for the tests of the exact decoder: any
sampling factors, 8- or 16-bit quantization tables, restart intervals,
component ids, JFIF and Adobe markers, and files that leave the Huffman
tables to the standard's defaults: layouts PIL's encoder does not write.
It returns its quantized coefficients beside the bytes, so that the
entropy decoder can be held to them; PIL's decode of the bytes is the
reference for the pixels."""

import numpy as np

# Zigzag position -> natural (row-major) position.
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# The standard's Annex K.3 tables: (counts of code lengths 1..16, values).
STD_DC = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0],
          list(range(12)))
STD_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
                 list(range(12)))
STD_AC = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], list(
    bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")))
STD_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], list(
    bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")))


def _codes(table):
    """value -> (code, length) of a canonical table."""
    counts, values = table
    out, code, k = {}, 0, 0
    for length, count in enumerate(counts, start=1):
        for _ in range(count):
            out[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class _Bits:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, value, length):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc = self.n = 0

    def flush(self):
        while self.n:
            self.put(1, 1)


def _fdct(block):
    """The 8x8 DCT in JPEG's scaling, natural order ``[64]``."""
    n = np.arange(8)
    c = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
    c[0] /= np.sqrt(2)
    return (0.25 * c @ block @ c.T).ravel()


def _segment(marker, body):
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _dht(tc, th, table):
    counts, values = table
    return bytes([(tc << 4) | th]) + bytes(counts) + bytes(values)


def _put_value(bits, codes, symbol, value, size):
    code, length = codes[symbol]
    bits.put(code, length)
    if size:
        bits.put(value if value >= 0 else value + (1 << size) - 1, size)


def _encode_block(bits, block, pred, dc_codes, ac_codes):
    zz = block[NATURAL].astype(np.int64)
    diff = int(zz[0]) - pred
    size = abs(diff).bit_length()
    _put_value(bits, dc_codes, size, diff, size)
    run = 0
    for k in range(1, 64):
        v = int(zz[k])
        if v == 0:
            run += 1
            continue
        while run > 15:
            _put_value(bits, ac_codes, 0xF0, 0, 0)
            run -= 16
        size = abs(v).bit_length()
        _put_value(bits, ac_codes, (run << 4) | size, v, size)
        run = 0
    if run:
        _put_value(bits, ac_codes, 0x00, 0, 0)
    return int(zz[0])


def write_jpeg(planes, factors, quant, restart=0, ids=None, app=b"",
               dqt16=False, std_tables=False):
    """``planes``: per component its full-size uint8 ``[H, W]`` samples
    (subsampled here by a box filter); ``factors``: per component ``(h,
    v)``; ``quant``: natural-order tables of 64 entries, component ``c``
    taking table ``min(c, len(quant) - 1)``. Returns ``(bytes,
    coefficients)``, the coefficients int16 ``[blocks_h, blocks_w, 64]``
    per component in natural order, padded to whole MCUs (zero where the
    scan codes nothing)."""
    height, width = planes[0].shape
    ncomp = len(planes)
    ids = ids or list(range(1, ncomp + 1))
    max_h = max(h for h, _ in factors)
    max_v = max(v for _, v in factors)
    mcus_x, mcus_y = -(-width // (8 * max_h)), -(-height // (8 * max_v))
    coefs, coded = [], []
    for c, (plane, (h, v)) in enumerate(zip(planes, factors)):
        he, ve = max_h // h, max_v // v
        cw, ch = -(-width * h // max_h), -(-height * v // max_v)
        pad = np.pad(plane.astype(np.float64),
                     ((0, ch * ve - height), (0, cw * he - width)),
                     mode="edge")
        small = pad.reshape(ch, ve, cw, he).mean(axis=(1, 3))
        bw, bh = mcus_x * h, mcus_y * v
        full = np.pad(small, ((0, bh * 8 - ch), (0, bw * 8 - cw)),
                      mode="edge") - 128.0
        q = np.asarray(quant[min(c, len(quant) - 1)], np.float64)
        blocks = np.zeros((bh, bw, 64), np.int16)
        for by in range(bh):
            for bx in range(bw):
                f = _fdct(full[by * 8:by * 8 + 8, bx * 8:bx * 8 + 8])
                blocks[by, bx] = np.round(f / q)
        if ncomp == 1:  # one component: a non-interleaved scan
            nbh, nbw = -(-ch // 8), -(-cw // 8)
            blocks[nbh:] = 0
            blocks[:, nbw:] = 0
            coded.append((nbh, nbw))
        coefs.append(blocks)

    tables = [(STD_DC, STD_AC), (STD_DC_CHROMA, STD_AC_CHROMA)]
    codes = [(_codes(dc), _codes(ac)) for dc, ac in tables]
    bits = _Bits()
    preds = [0] * ncomp
    if ncomp == 1:
        units = [[(0, y, x)] for y in range(coded[0][0])
                 for x in range(coded[0][1])]
    else:
        units = [[(c, my * v + by, mx * h + bx)
                  for c, (h, v) in enumerate(factors)
                  for by in range(v) for bx in range(h)]
                 for my in range(mcus_y) for mx in range(mcus_x)]
    for i, unit in enumerate(units):
        if restart and i and i % restart == 0:
            bits.flush()
            bits.out += bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
            preds = [0] * ncomp
        for c, y, x in unit:
            dc_codes, ac_codes = codes[min(c, 1)]
            preds[c] = _encode_block(bits, coefs[c][y, x], preds[c],
                                     dc_codes, ac_codes)
    bits.flush()

    out = bytearray(b"\xff\xd8") + app
    for t, q in enumerate(quant):
        q = np.asarray(q)[NATURAL]
        if dqt16:
            out += _segment(0xDB, bytes([0x10 | t]) + b"".join(
                int(v).to_bytes(2, "big") for v in q))
        else:
            out += _segment(0xDB, bytes([t]) + bytes(int(v) for v in q))
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big")
    sof += bytes([ncomp])
    for c, (h, v) in enumerate(factors):
        sof += bytes([ids[c], (h << 4) | v, min(c, len(quant) - 1)])
    out += _segment(0xC1 if dqt16 else 0xC0, sof)
    if not std_tables:
        for t, (dc, ac) in enumerate(tables[:min(ncomp, 2)]):
            out += _segment(0xC4, _dht(0, t, dc) + _dht(1, t, ac))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    sos = bytes([ncomp])
    for c in range(ncomp):
        t = min(c, 1)
        sos += bytes([ids[c], (t << 4) | t])
    out += _segment(0xDA, sos + bytes([0, 63, 0]))
    out += bits.out + b"\xff\xd9"
    return bytes(out), coefs


JFIF = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform):
    """An APP14 Adobe marker with ``transform`` (0, 1 or 2)."""
    return _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes(
        [transform]))
