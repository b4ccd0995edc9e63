"""Host-side image decode/encode (the reference's imread/imwrite sites).

The reference does disk I/O through OpenCV (reference src/srcnn.cpp:462
``imread``, :670 ``imwrite``).  We prefer the same codecs via the cv2 binding
(bit-identical decode for JPEG/PNG), falling back to PIL when cv2 is absent,
and to the standard-library PNG codec below when neither is installed.
All in-memory images are BGR uint8 HxWx3, matching the reference convention.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

try:
    import cv2  # type: ignore

    _HAVE_CV2 = True
except Exception:  # pragma: no cover - exercised only on cv2-less installs
    _HAVE_CV2 = False


def sniff_format(path: str | Path) -> str | None:
    """Magic-byte format detection (reference test.cpp:136-195 parity).

    Returns "jpeg", "png", "bmp", or None.
    """
    try:
        with open(path, "rb") as f:
            head = f.read(8)
    except OSError:
        return None
    if head[:2] == b"\xff\xd8":
        return "jpeg"
    if head[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if head[:2] == b"BM":
        return "bmp"
    return None


def conv_image(buf, w: int, h: int, d: int) -> np.ndarray:
    """Normalize an interleaved pixel buffer to 3-channel RGB uint8 [H,W,3].

    Mirrors the reference harness's ``convImage`` (reference
    src/test.cpp:34-134), the front-end that feeds ``ProcessSRCNN``:

    * ``d=1``  gray: replicated into R=G=B (test.cpp:47-60);
    * ``d=2``  RGB565 (native-u16): fields extracted as R=(px&0xF800)>>11,
      G=(px&0x07E0)>>5, B=px&0x001F — the reference does NOT expand them
      to 8-bit range (test.cpp:71-83), and that quirk is preserved;
    * ``d=3``  passed through (test.cpp:121-128 ``copy()``);
    * ``d=4``  RGBA: alpha-premultiplied RGB, alpha dropped, float->u8 by
      C-cast truncation (test.cpp:95-108 intent; the reference's
      ``unsigned short*`` cast there mis-indexes an RGBA8 buffer — a bug
      not reproduced, like frawscale's sizeof(short) memcpy).
    """
    # d=2 uses NATIVE uint16, like the reference's ``unsigned short*`` cast
    # (test.cpp:71): the byte order follows the host, not a fixed endianness.
    a = np.frombuffer(np.ascontiguousarray(buf), dtype=np.uint8) \
        if d != 2 else np.frombuffer(np.ascontiguousarray(buf), dtype=np.uint16)
    if d == 1:
        px = a.reshape(h, w)
        return np.repeat(px[..., None], 3, axis=-1)
    if d == 2:
        px = a.reshape(h, w).astype(np.uint16)
        r = ((px & 0xF800) >> 11).astype(np.uint8)
        g = ((px & 0x07E0) >> 5).astype(np.uint8)
        b = (px & 0x001F).astype(np.uint8)
        return np.stack([r, g, b], axis=-1)
    if d == 3:
        return a.reshape(h, w, 3).copy()
    if d == 4:
        px = a.reshape(h, w, 4)
        alp = px[..., 3:4].astype(np.float32) / 255.0
        return (px[..., :3].astype(np.float32) * alp).astype(np.uint8)
    raise ValueError(f"unsupported depth {d}; expected 1, 2, 3 or 4")


def decode_provenance() -> dict:
    """Identify the image decoder in use: ``{"decoder", "version"}``.

    JPEG decode differs between cv2 (libjpeg-turbo build settings) and
    PIL, which shifts eval PSNR in the 3rd decimal — recorded EVAL.md
    numbers pin the decoder that minted them (cv2 5.0.0 on this host) and
    ``evaluate`` embeds this provenance in its output.
    """
    if _HAVE_CV2:
        return {"decoder": "cv2", "version": cv2.__version__}
    try:
        import PIL

        return {"decoder": "PIL", "version": PIL.__version__}
    except Exception:  # pragma: no cover
        return {"decoder": "png-zlib", "version": ""}


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters of ``raw [H, 1 + stride]`` (8-bit)."""
    h, stride = raw.shape[0], raw.shape[1] - 1
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, f = int(raw[y, 0]), raw[y, 1:]
        if ftype == 0:
            cur = f.copy()
        elif ftype == 1:      # Sub: running sum along each channel
            cur = (np.cumsum(f.reshape(-1, bpp).astype(np.int64), axis=0)
                   % 256).astype(np.uint8).reshape(-1)
        elif ftype == 2:      # Up
            cur = f + prev
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            fb, pb = f.tolist(), prev.tolist()
            cb = [0] * stride
            for x in range(stride):
                a = cb[x - bpp] if x >= bpp else 0
                b = pb[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = pb[x - bpp] if x >= bpp else 0
                    pa, pbd, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pbd and pa <= pc else (
                        b if pbd <= pc else c)
                cb[x] = (fb[x] + pred) & 0xFF
            cur = np.asarray(cb, np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def png_decode(data: bytes) -> np.ndarray:
    """8-bit non-interlaced PNG bytes -> uint8 ``[H, W, C]`` (file order:
    gray, gray+alpha, RGB or RGBA; palettes are expanded to RGB)."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, idat, plte, hdr = 8, [], None, None
    while pos + 8 <= len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace or ctype not in _PNG_CHANNELS:
        raise ValueError(f"unsupported PNG (depth {depth}, colour type "
                         f"{ctype}, interlace {interlace})")
    ch = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _png_unfilter(raw.reshape(h, 1 + w * ch), ch).reshape(h, w, ch)
    if ctype == 3:
        img = plte[img[..., 0]]
    return img


def png_encode(img: np.ndarray) -> bytes:
    """uint8 ``[H, W]`` (gray) or ``[H, W, 3|4]`` (RGB/RGBA) -> PNG bytes."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[ch]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * ch)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_PNG_SIG
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def _png_read_bgr(path: str) -> np.ndarray | None:
    try:
        img = png_decode(Path(path).read_bytes())
    except (OSError, ValueError, zlib.error):
        return None
    if img.shape[2] in (1, 2):          # gray (+alpha) -> 3 gray channels
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., 2::-1])  # RGB(A) -> BGR


def imread_bgr(path: str | Path) -> np.ndarray | None:
    """Decode an image file to BGR uint8 [H, W, 3]; None on failure."""
    path = str(path)
    if _HAVE_CV2:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        return img if img is not None and img.size else None
    try:
        from PIL import Image

        rgb = np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)
        return rgb[..., ::-1].copy()
    except ImportError:
        return _png_read_bgr(path)
    except Exception:
        return None


def imwrite_bgr(path: str | Path, bgr: np.ndarray) -> bool:
    """Encode a BGR uint8 image to ``path`` (format from extension)."""
    path = str(path)
    bgr = np.asarray(bgr, dtype=np.uint8)
    if _HAVE_CV2:
        return bool(cv2.imwrite(path, bgr))
    try:
        from PIL import Image

        Image.fromarray(bgr[..., ::-1]).save(path)
        return True
    except ImportError:
        if Path(path).suffix.lower() != ".png":
            return False
        try:
            Path(path).write_bytes(png_encode(bgr[..., ::-1]))
            return True
        except OSError:
            return False
    except Exception:
        return False
