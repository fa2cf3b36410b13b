"""Copy of ``amico_tpu/io/nifti.py`` for the port, which imports nothing of
``amico_tpu``.

Pure-NumPy NIfTI I/O (NIfTI-1 read/write, NIfTI-2 read).

The reference delegates image I/O to ``nibabel`` (reference amico/core.py:9,
135-150, 542-609).  nibabel is not a dependency of this framework, so we
implement the subset the pipeline needs:

* read ``.nii`` / ``.nii.gz`` single-file images and ``.hdr``/``.img``
  pairs, both NIfTI-1 (348-byte header, magic ``n+1``/``ni1``) and NIfTI-2
  (540-byte header, magic ``n+2``/``ni2``), either endianness, honoring
  dtype, dims, ``scl_slope``/``scl_inter`` rescale (reference
  core.py:146-150) and returning data in Fortran (x fastest) order like
  nibabel's ``get_fdata``;
* write float32 NIfTI-1 images with affine (qform/sform), ``descrip``,
  ``cal_min``/``cal_max`` header fields (reference core.py:542-609) --
  the reference writes ``nibabel.Nifti1Image`` outputs, so results stay
  NIfTI-1 for parity even when the input was NIfTI-2.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_HDR_SIZE = 348
_MAGIC = b'n+1\x00'

# NIfTI-1 datatype codes -> numpy dtypes
_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


class Nifti1Header:
    """Parsed NIfTI-1 header fields we care about."""

    def __init__(self):
        self.dim = np.ones(8, dtype=np.int64)
        self.datatype = 16
        self.bitpix = 32
        self.pixdim = np.ones(8, dtype=np.float64)
        self.vox_offset = 352.0
        self.scl_slope = 1.0
        self.scl_inter = 0.0
        self.cal_min = 0.0
        self.cal_max = 0.0
        self.descrip = b''
        self.qform_code = 0
        # 0 until a real affine is set: claiming a valid sform while srow
        # is all-zero would publish a degenerate geometry
        self.sform_code = 0
        self.quatern = np.zeros(3)
        self.qoffset = np.zeros(3)
        self.srow = np.zeros((3, 4))
        self.xyzt_units = 10  # mm | sec
        self.endian = '<'
        # True when parsed from an .hdr of a two-file pair (magic ni1/ni2)
        self._pair = False

    @property
    def shape(self) -> tuple[int, ...]:
        nd = int(self.dim[0])
        return tuple(int(d) for d in self.dim[1:1 + nd])

    def get_zooms(self) -> tuple[float, ...]:
        nd = int(self.dim[0])
        return tuple(float(z) for z in self.pixdim[1:1 + nd])

    @property
    def affine(self) -> np.ndarray:
        aff = np.eye(4)
        if self.sform_code > 0:
            aff[:3, :] = self.srow
        elif self.qform_code > 0:
            b, c, d = self.quatern
            a2 = 1.0 - (b * b + c * c + d * d)
            a = np.sqrt(max(a2, 0.0))
            R = np.array([
                [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
                [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
                [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
            ])
            qfac = -1.0 if self.pixdim[0] == -1.0 else 1.0
            zooms = np.array([self.pixdim[1], self.pixdim[2], qfac * self.pixdim[3]])
            aff[:3, :3] = R * zooms
            aff[:3, 3] = self.qoffset
        else:
            aff[:3, :3] = np.diag(self.pixdim[1:4])
        return aff


class Nifti1Image:
    """Thin image container mirroring the nibabel API surface used by the
    reference (``get_fdata``, ``affine``, ``header``, ``shape``)."""

    def __init__(self, dataobj: np.ndarray, affine: np.ndarray | None = None,
                 header: Nifti1Header | None = None):
        self._data = np.asarray(dataobj)
        self.header = header if header is not None else Nifti1Header()
        if affine is not None:
            self.header.srow = np.asarray(affine, dtype=np.float64)[:3, :]
            self.header.sform_code = 1
        self.header.dim[:] = 1
        self.header.dim[0] = self._data.ndim
        self.header.dim[1:1 + self._data.ndim] = self._data.shape

    @property
    def affine(self) -> np.ndarray:
        return self.header.affine

    @property
    def shape(self) -> tuple[int, ...]:
        return self._data.shape

    @property
    def ndim(self) -> int:
        return self._data.ndim

    @property
    def dataobj(self) -> np.ndarray:
        """The stored array, raw (no scl scaling) -- nibabel-style."""
        return self._data

    def get_fdata(self, dtype=np.float64) -> np.ndarray:
        """Floating-point data with ``scl_slope``/``scl_inter`` applied,
        matching nibabel semantics (finite nonzero slope enables scaling;
        a non-finite inter counts as 0).  Raw values are on ``dataobj``;
        the DWI pipeline scales explicitly via ``intensity_rescale`` so it
        can log the fact (reference core.py:146-150)."""
        out = self._data.astype(dtype)
        sl = float(self.header.scl_slope)
        it = float(self.header.scl_inter)
        it = it if np.isfinite(it) else 0.0
        if np.isfinite(sl) and sl != 0.0 and (sl != 1.0 or it != 0.0):
            out = out * sl + it
        return out


def _read_bytes(filename: str) -> bytes:
    opener = gzip.open if str(filename).endswith('.gz') else open
    with opener(filename, 'rb') as f:
        return f.read()


def _companion(filename: str, ext: str) -> str:
    """Sibling file of an .hdr/.img pair, preserving optional .gz."""
    name = str(filename)
    gz = name.endswith('.gz')
    stem = name[:-3] if gz else name
    stem = stem[:stem.rfind('.')]
    return stem + ext + ('.gz' if gz else '')


_HDR2_SIZE = 540


def _parse_nifti1(raw: bytes, endian: str, filename: str) -> Nifti1Header:
    hdr = Nifti1Header()
    hdr.endian = endian
    magic = raw[344:348]
    if magic not in (b'n+1\x00', b'ni1\x00'):
        raise ValueError(f'{filename}: bad NIfTI magic {magic!r}')
    u = lambda fmt, off: struct.unpack(endian + fmt, raw[off:off + struct.calcsize(fmt)])

    hdr.dim = np.array(u('8h', 40), dtype=np.int64)
    hdr.datatype = u('h', 70)[0]
    hdr.bitpix = u('h', 72)[0]
    hdr.pixdim = np.array(u('8f', 76), dtype=np.float64)
    hdr.vox_offset = u('f', 108)[0]
    hdr.scl_slope = u('f', 112)[0]
    hdr.scl_inter = u('f', 116)[0]
    hdr.cal_max = u('f', 124)[0]
    hdr.cal_min = u('f', 128)[0]
    hdr.descrip = raw[148:228].split(b'\x00')[0]
    hdr.qform_code = u('h', 252)[0]
    hdr.sform_code = u('h', 254)[0]
    hdr.quatern = np.array(u('3f', 256), dtype=np.float64)
    hdr.qoffset = np.array(u('3f', 268), dtype=np.float64)
    hdr.srow = np.array(u('12f', 280), dtype=np.float64).reshape(3, 4)
    hdr.xyzt_units = raw[123]
    hdr._pair = magic == b'ni1\x00'
    return hdr


def _parse_nifti2(raw: bytes, endian: str, filename: str) -> Nifti1Header:
    """NIfTI-2 header (540 bytes, official nifti2.h layout): same fields as
    NIfTI-1 widened to int64/double, magic at offset 4.  Parsed into the
    same in-memory header class -- downstream code is format-agnostic."""
    hdr = Nifti1Header()
    hdr.endian = endian
    magic = raw[4:12]
    if magic[:4] not in (b'n+2\x00', b'ni2\x00'):
        raise ValueError(f'{filename}: bad NIfTI-2 magic {magic!r}')
    # nifti2.h requires signature bytes 8-11 = \r\n\x1a\n as corruption
    # detection (a text-mode transfer mangles \r\n); refuse silently-broken
    # files instead of parsing garbage offsets
    if magic[4:8] != b'\r\n\x1a\n':
        raise ValueError(
            f'{filename}: NIfTI-2 signature bytes corrupted '
            f'(got {magic[4:8]!r}, want CR LF SUB LF -- possible '
            f'text-mode transfer corruption)')
    u = lambda fmt, off: struct.unpack(endian + fmt, raw[off:off + struct.calcsize(fmt)])

    hdr.datatype = u('h', 12)[0]
    hdr.bitpix = u('h', 14)[0]
    hdr.dim = np.array(u('8q', 16), dtype=np.int64)
    hdr.pixdim = np.array(u('8d', 104), dtype=np.float64)
    hdr.vox_offset = float(u('q', 168)[0])
    hdr.scl_slope = u('d', 176)[0]
    hdr.scl_inter = u('d', 184)[0]
    hdr.cal_max = u('d', 192)[0]
    hdr.cal_min = u('d', 200)[0]
    hdr.descrip = raw[240:320].split(b'\x00')[0]
    hdr.qform_code = u('i', 344)[0]
    hdr.sform_code = u('i', 348)[0]
    hdr.quatern = np.array(u('3d', 352), dtype=np.float64)
    hdr.qoffset = np.array(u('3d', 376), dtype=np.float64)
    hdr.srow = np.array(u('12d', 400), dtype=np.float64).reshape(3, 4)
    hdr.xyzt_units = u('i', 500)[0] & 0xff
    hdr._pair = magic[:4] == b'ni2\x00'
    return hdr


def load(filename: str, mmap: bool = True) -> Nifti1Image:
    """Load a NIfTI image (raw, unscaled data).

    Supports single-file ``.nii``/``.nii.gz`` and two-file ``.hdr``/``.img``
    pairs, NIfTI-1 (magic ``n+1``/``ni1``) and NIfTI-2 (magic
    ``n+2``/``ni2``), either endianness.

    With ``mmap`` (default), uncompressed files are memory-mapped
    read-only instead of read into RAM: ``dataobj`` then touches the page
    cache lazily and the eager full-file read/copy disappears from the
    load path (gzipped files always decompress into memory).  Either way
    ``dataobj`` is read-only, matching the ``np.frombuffer`` behavior.
    """
    name = str(filename)
    if name.replace('.gz', '').endswith('.img'):
        name = _companion(name, '.hdr')
    gz = name.endswith('.gz')
    if gz or not mmap:
        raw = _read_bytes(name)
        head = raw[:_HDR2_SIZE]
    else:
        with open(name, 'rb') as f:
            head = f.read(_HDR2_SIZE)
        raw = None
    if len(head) < _HDR_SIZE:
        raise ValueError(f'{filename}: too small to be a NIfTI file')
    endian = None
    for e in ('<', '>'):
        sz = struct.unpack(e + 'i', head[0:4])[0]
        if sz in (_HDR_SIZE, _HDR2_SIZE):
            endian, sizeof_hdr = e, sz
            break
    if endian is None:
        raise ValueError(f'{filename}: bad sizeof_hdr (not a NIfTI file?)')
    if sizeof_hdr == _HDR2_SIZE:
        if len(head) < _HDR2_SIZE:
            raise ValueError(f'{filename}: truncated NIfTI-2 header')
        hdr = _parse_nifti2(head, endian, filename)
    else:
        hdr = _parse_nifti1(head, endian, filename)

    if hdr.datatype not in _DTYPES:
        raise ValueError(f'{filename}: unsupported NIfTI datatype {hdr.datatype}')
    dtype = np.dtype(_DTYPES[hdr.datatype]).newbyteorder(endian)
    shape = hdr.shape
    count = int(np.prod(shape)) if shape else 0
    data_name = _companion(name, '.img') if hdr._pair else name
    off = int(hdr.vox_offset)
    if raw is None:
        need = off + count * dtype.itemsize
        if count and os.path.getsize(data_name) < need:
            raise ValueError(f'{filename}: data truncated '
                             f'(need {count} x {dtype} at offset {off})')
        data = np.memmap(data_name, dtype=dtype, mode='r', offset=off,
                         shape=(count,))
    else:
        if hdr._pair:
            # two-file pair: voxels live in the sibling .img at vox_offset
            raw = _read_bytes(data_name)
        if count and len(raw) < off + count * dtype.itemsize:
            raise ValueError(f'{filename}: data truncated '
                             f'(need {count} x {dtype} at offset {off})')
        data = np.frombuffer(raw, dtype=dtype, count=count, offset=off)
    # NIfTI voxel data is Fortran-ordered (x fastest)
    data = data.reshape(shape, order='F')
    return Nifti1Image(data, header=hdr)


def save(img: Nifti1Image, filename: str, compresslevel: int = 1) -> None:
    """Write a single-file NIfTI-1 image (.nii or .nii.gz).

    ``compresslevel`` applies to ``.nii.gz`` outputs; the default 1
    deflates the float32 parameter maps ~4x faster than gzip's default 9
    for a few percent larger files (save_results is a per-subject
    pipeline stage; the maps are a few MB each).
    """
    data = np.asarray(img._data)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    hdr = img.header
    code = _DTYPE_CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8

    buf = bytearray(352)
    struct.pack_into('<i', buf, 0, _HDR_SIZE)
    dim = np.ones(8, dtype=np.int16)
    dim[0] = data.ndim
    dim[1:1 + data.ndim] = data.shape
    struct.pack_into('<8h', buf, 40, *dim)
    struct.pack_into('<h', buf, 70, code)
    struct.pack_into('<h', buf, 72, bitpix)
    pixdim = np.asarray(hdr.pixdim, dtype=np.float32).copy()
    struct.pack_into('<8f', buf, 76, *pixdim)
    struct.pack_into('<f', buf, 108, 352.0)
    struct.pack_into('<f', buf, 112, float(hdr.scl_slope) if np.isfinite(hdr.scl_slope) else 1.0)
    struct.pack_into('<f', buf, 116, float(hdr.scl_inter) if np.isfinite(hdr.scl_inter) else 0.0)
    struct.pack_into('<f', buf, 124, float(hdr.cal_max))
    struct.pack_into('<f', buf, 128, float(hdr.cal_min))
    buf[123] = hdr.xyzt_units
    descrip = bytes(hdr.descrip)[:79]
    buf[148:148 + len(descrip)] = descrip
    struct.pack_into('<h', buf, 252, int(hdr.qform_code))
    # preserve sform_code as-is: forcing it >= 1 on a qform-only image
    # would publish an all-zero srow as a "valid" sform and destroy the
    # geometry for any consumer that prefers sform
    struct.pack_into('<h', buf, 254, int(hdr.sform_code))
    struct.pack_into('<3f', buf, 256, *np.asarray(hdr.quatern, dtype=np.float32))
    struct.pack_into('<3f', buf, 268, *np.asarray(hdr.qoffset, dtype=np.float32))
    srow = np.asarray(hdr.srow, dtype=np.float32).reshape(-1)
    struct.pack_into('<12f', buf, 280, *srow)
    buf[344:348] = _MAGIC

    payload = bytes(buf) + data.tobytes(order='F')
    if str(filename).endswith('.gz'):
        with gzip.open(filename, 'wb', compresslevel=compresslevel) as f:
            f.write(payload)
    else:
        with open(filename, 'wb') as f:
            f.write(payload)
