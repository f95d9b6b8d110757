"""The subset of msgpack that flax's serialization.to_bytes / from_bytes
write and read, decoded and encoded with struct and numpy alone (no
msgpack, flax or jax package): the arbiters' shipped weights
(weights/autoencoder.pt, weights/classifier.pt) hold their params as such
bytes, and the port's Arbiter.save writes them back in the same form; a
JAX package's model.pt is its whole TrainState in them
(models/base.py read_checkpoint).

Types: nil, bools, ints, floats (32 and 64 bit), str, bin, arrays, maps
(fix, 16 and 32 bit forms of each), and flax's ext type 1, an ndarray as a
msgpack array (shape, dtype name, C-order bytes). The encoder picks the
smallest form of each value, as the msgpack package does, and writes a
map's keys sorted, as flax does, so a tree encodes to flax's bytes for it
(or, with sort_keys=False, in the tree's own order, as flax keeps a
dataclass's fields).
Arrays decode as lists; an ndarray leaf decodes as a writable numpy array.
flax's chunked form of leaves past 2**30 bytes is not read or written (no
arbiter comes near it).
"""

import struct

import numpy as np

EXT_NDARRAY = 1


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError('msgpack: truncated input')
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray(data):
    shape, dtype, buf = decode(data, raw_str=True)
    arr = np.frombuffer(bytes(buf), dtype=np.dtype(dtype.decode()))
    return arr.reshape(shape).copy()


def _ext(code, data):
    if code != EXT_NDARRAY:
        raise ValueError(f'msgpack: ext type {code} is not one flax writes for params')
    return _ndarray(data)


def _read(r, raw_str):
    b = r.unpack('B')
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F, raw_str)
    if 0x90 <= b <= 0x9F:
        return [_read(r, raw_str) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F), raw_str)
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
        return bytes(r.take(r.unpack({0xC4: 'B', 0xC5: '>H', 0xC6: '>I'}[b])))
    if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
        n = r.unpack({0xC7: 'B', 0xC8: '>H', 0xC9: '>I'}[b])
        code = r.unpack('b')
        return _ext(code, r.take(n))
    if b in (0xCA, 0xCB):
        return r.unpack('>f' if b == 0xCA else '>d')
    ints = {0xCC: 'B', 0xCD: '>H', 0xCE: '>I', 0xCF: '>Q',
            0xD0: 'b', 0xD1: '>h', 0xD2: '>i', 0xD3: '>q'}
    if b in ints:
        return r.unpack(ints[b])
    if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
        code = r.unpack('b')
        return _ext(code, r.take(1 << (b - 0xD4)))
    if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
        return _str(r.take(r.unpack({0xD9: 'B', 0xDA: '>H', 0xDB: '>I'}[b])), raw_str)
    if b in (0xDC, 0xDD):  # array 16/32
        return [_read(r, raw_str) for _ in range(r.unpack('>H' if b == 0xDC else '>I'))]
    if b in (0xDE, 0xDF):  # map 16/32
        return _read_map(r, r.unpack('>H' if b == 0xDE else '>I'), raw_str)
    raise ValueError(f'msgpack: unknown type byte 0x{b:02x}')


def _str(mv, raw_str):
    return bytes(mv) if raw_str else str(mv, 'utf-8')


def _read_map(r, n, raw_str):
    out = {}
    for _ in range(n):
        k = _read(r, raw_str)
        out[k] = _read(r, raw_str)
    return out


def decode(buf, raw_str=False):
    """msgpack bytes -> a tree of dicts, lists, numpy arrays and Python
    scalars (flax.serialization.msgpack_restore's tree, for the types above).
    raw_str keeps str values as bytes."""
    r = _Reader(buf)
    out = _read(r, raw_str)
    if r.pos != len(r.buf):
        raise ValueError(f'msgpack: {len(r.buf) - r.pos} bytes after the value')
    return out


def _head(out, n, fix, fix_max, codes):
    """A length header: the fix form's byte, else the 8/16/32-bit form's
    (codes: the byte of each, None where the type has no 8-bit form)."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack('B', fix | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack('BB', codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack('>BH', codes[1], n))
    else:
        out.append(struct.pack('>BI', codes[2], n))


def _write_int(out, v):
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out.append(struct.pack('b' if v < 0 else 'B', v))
        return
    forms = ((0xCC, 'B', 0, 0xFF), (0xCD, '>H', 0, 0xFFFF), (0xCE, '>I', 0, 0xFFFFFFFF),
             (0xCF, '>Q', 0, 2 ** 64 - 1)) if v >= 0 else (
        (0xD0, 'b', -0x80, 0x7F), (0xD1, '>h', -0x8000, 0x7FFF),
        (0xD2, '>i', -2 ** 31, 2 ** 31 - 1), (0xD3, '>q', -2 ** 63, 2 ** 63 - 1))
    for code, fmt, lo, hi in forms:
        if lo <= v <= hi:
            out.append(struct.pack('B', code) + struct.pack(fmt, v))
            return
    raise ValueError(f'msgpack: int {v} out of range')


def _write_ext(out, code, data):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(struct.pack('Bb', fixed[n], code))
    else:
        _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out.append(struct.pack('b', code))
    out.append(data)


def _array_bytes(a):
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError('msgpack: object and structured dtypes are not supported')
    return encode([list(a.shape), a.dtype.name, a.tobytes('C')])


def _write(out, v, sort_keys=True):
    if v is None:
        out.append(b'\xc0')
    elif v is True or v is False:
        out.append(b'\xc3' if v else b'\xc2')
    elif isinstance(v, np.ndarray):
        _write_ext(out, EXT_NDARRAY, _array_bytes(v))
    elif isinstance(v, int):
        _write_int(out, v)
    elif isinstance(v, float):
        out.append(struct.pack('>Bd', 0xCB, v))
    elif isinstance(v, str):
        s = v.encode('utf-8')
        _head(out, len(s), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out.append(s)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        _head(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(bytes(v))
    elif isinstance(v, (list, tuple)):
        _head(out, len(v), 0x90, 15, (None, 0xDC, 0xDD))
        for x in v:
            _write(out, x, sort_keys)
    elif isinstance(v, dict):
        _head(out, len(v), 0x80, 15, (None, 0xDE, 0xDF))
        # flax's tree_map sorts a dict's keys; a dataclass's (TrainState) and
        # a namedtuple's fields keep their order
        for k, x in (sorted(v.items()) if sort_keys else v.items()):
            _write(out, k)
            _write(out, x, sort_keys)
    else:
        raise TypeError(f'msgpack: cannot encode {type(v).__name__}')


def encode(tree, sort_keys=True):
    """A tree of dicts (str keys), lists, numpy arrays, ints, floats, str,
    bytes, bools and None -> msgpack bytes, ndarrays as flax's ext type 1
    (what flax.serialization.msgpack_restore reads). sort_keys=False
    writes each dict in its own order: a flax state dict whose dataclass
    and namedtuple fields keep theirs (a TrainState's params, opt_state,
    step, rng, extra), the caller sorting the dicts that flax sorts."""
    out = []
    _write(out, tree, sort_keys)
    return b''.join(out)
