"""HPACK, header compression for HTTP/2 (RFC 7541).

The decoder reads every representation a peer may send: indexed fields
from the static and the dynamic table, literals with incremental indexing,
without indexing and never indexed, dynamic table size updates (held to
the size our SETTINGS allow), and strings in Huffman code. The encoder
writes every field as a literal without indexing and without Huffman code,
which every decoder must accept and which leaves no state to share.

Header names and values are ``str`` decoded as Latin-1: an octet maps to
one character, so any value, ``-bin`` metadata's base64 included, crosses
unchanged.
"""

from __future__ import annotations

from collections import deque


class HpackError(ValueError):
    """A header block that does not decode (a COMPRESSION_ERROR)."""


#: RFC 7541 Appendix A, entries 1..61
STATIC_TABLE: tuple[tuple[str, str], ...] = (
    (":authority", ""), (":method", "GET"), (":method", "POST"), (":path", "/"),
    (":path", "/index.html"), (":scheme", "http"), (":scheme", "https"), (":status", "200"),
    (":status", "204"), (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""), ("accept-ranges", ""),
    ("accept", ""), ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""), ("content-disposition", ""),
    ("content-encoding", ""), ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""), ("cookie", ""),
    ("date", ""), ("etag", ""), ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""), ("location", ""),
    ("max-forwards", ""), ("proxy-authenticate", ""), ("proxy-authorization", ""),
    ("range", ""), ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""), ("transfer-encoding", ""),
    ("user-agent", ""), ("vary", ""), ("via", ""), ("www-authenticate", ""),
)

#: RFC 7541 Appendix B by code length: the symbols (octets, 256 = EOS) of
#: each length. The code is canonical: codes ascend with their length and,
#: within one length, with the symbol, starting from all zeros, so the
#: lengths define it (the last code, EOS, is thirty ones).
HUFFMAN_SYMBOLS_BY_LENGTH: dict[int, tuple[int, ...]] = {
    5: (48, 49, 50, 97, 99, 101, 105, 111, 115, 116),
    6: (32, 37, 45, 46, 47, 51, 52, 53, 54, 55, 56, 57, 61, 65, 95, 98, 100, 102, 103, 104,
        108, 109, 110, 112, 114, 117),
    7: (58, 66, 67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85,
        86, 87, 89, 106, 107, 113, 118, 119, 120, 121, 122),
    8: (38, 42, 44, 59, 88, 90),
    10: (33, 34, 40, 41, 63),
    11: (39, 43, 124),
    12: (35, 62),
    13: (0, 36, 64, 91, 93, 126),
    14: (94, 125),
    15: (60, 96, 123),
    19: (92, 195, 208),
    20: (128, 130, 131, 162, 184, 194, 224, 226),
    21: (153, 161, 167, 172, 176, 177, 179, 209, 216, 217, 227, 229, 230),
    22: (129, 132, 133, 134, 136, 146, 154, 156, 160, 163, 164, 169, 170, 173, 178, 181, 185,
         186, 187, 189, 190, 196, 198, 228, 232, 233),
    23: (1, 135, 137, 138, 139, 140, 141, 143, 147, 149, 150, 151, 152, 155, 157, 158, 165,
         166, 168, 174, 175, 180, 182, 183, 188, 191, 197, 231, 239),
    24: (9, 142, 144, 145, 148, 159, 171, 206, 215, 225, 236, 237),
    25: (199, 207, 234, 235),
    26: (192, 193, 200, 201, 202, 205, 210, 213, 218, 219, 238, 240, 242, 243, 255),
    27: (203, 204, 211, 212, 214, 221, 222, 223, 241, 244, 245, 246, 247, 248, 250, 251, 252,
         253, 254),
    28: (2, 3, 4, 5, 6, 7, 8, 11, 12, 14, 15, 16, 17, 18, 19, 20, 21, 23, 24, 25, 26, 27, 28,
         29, 30, 31, 127, 220, 249),
    30: (10, 13, 22, 256),
}
EOS = 256


def _canonical() -> tuple[list[tuple[int, int]], dict[int, dict[int, int]]]:
    codes: list[tuple[int, int]] = [(0, 0)] * 257
    decode: dict[int, dict[int, int]] = {}
    code, previous = 0, None
    for length in sorted(HUFFMAN_SYMBOLS_BY_LENGTH):
        if previous is not None:
            code <<= length - previous
        table = decode.setdefault(length, {})
        for symbol in sorted(HUFFMAN_SYMBOLS_BY_LENGTH[length]):
            codes[symbol] = (code, length)
            table[code] = symbol
            code += 1
        previous = length
    return codes, decode


#: symbol -> (code, length in bits)
HUFFMAN_CODES, _DECODE = _canonical()
_LENGTHS = tuple(sorted(_DECODE))


def huffman_encode(data: bytes) -> bytes:
    acc = nbits = 0
    out = bytearray()
    for byte in data:
        code, length = HUFFMAN_CODES[byte]
        acc = (acc << length) | code
        nbits += length
        while nbits >= 8:
            nbits -= 8
            out.append((acc >> nbits) & 0xFF)
        acc &= (1 << nbits) - 1
    if nbits:  # pad with the most significant bits of EOS (ones)
        out.append(((acc << (8 - nbits)) | ((1 << (8 - nbits)) - 1)) & 0xFF)
    return bytes(out)


def huffman_decode(data: bytes) -> bytes:
    """Refuses a string that holds EOS, a bit sequence that is no code, and
    padding that is longer than 7 bits or not the most significant bits of
    EOS (RFC 7541 5.2)."""
    out = bytearray()
    acc = nbits = 0
    for byte in data:
        acc = (acc << 8) | byte
        nbits += 8
        while nbits >= _LENGTHS[0]:
            symbol = None
            for length in _LENGTHS:
                if length > nbits:
                    break
                symbol = _DECODE[length].get(acc >> (nbits - length))
                if symbol is not None:
                    break
            if symbol is None:
                if nbits >= _LENGTHS[-1]:
                    raise HpackError("invalid Huffman code")
                break  # a longer code: wait for the next octet
            if symbol == EOS:
                raise HpackError("Huffman string holds EOS")
            out.append(symbol)
            nbits -= length
            acc &= (1 << nbits) - 1
    if nbits > 7:
        raise HpackError("Huffman padding longer than 7 bits")
    if acc != (1 << nbits) - 1:
        raise HpackError("Huffman padding is not a prefix of EOS")
    return bytes(out)


def encode_integer(value: int, prefix_bits: int, first: int = 0) -> bytes:
    """An integer with an N-bit prefix (RFC 7541 5.1); ``first`` holds the
    representation's flag bits above the prefix."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes([first | value])
    out = bytearray([first | limit])
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_integer(data: bytes, pos: int, prefix_bits: int) -> tuple[int, int]:
    if pos >= len(data):
        raise HpackError("truncated integer")
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("truncated integer")
        byte = data[pos]
        pos += 1
        value += (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7
        if shift > 28:
            raise HpackError("integer too large")


def _decode_string(data: bytes, pos: int) -> tuple[str, int]:
    if pos >= len(data):
        raise HpackError("truncated string")
    huffman = data[pos] & 0x80
    length, pos = decode_integer(data, pos, 7)
    end = pos + length
    if end > len(data):
        raise HpackError("truncated string")
    raw = data[pos:end]
    if huffman:
        raw = huffman_decode(raw)
    return raw.decode("latin-1"), end


def _entry_size(name: str, value: str) -> int:
    return len(name) + len(value) + 32


class Decoder:
    """One connection's decoding context (the peer's encoder's dynamic
    table mirrored)."""

    def __init__(self, max_table_size: int = 4096):
        #: the most our SETTINGS_HEADER_TABLE_SIZE lets the peer use
        self.settings_limit = max_table_size
        self.max_size = max_table_size
        self.size = 0
        self.table: deque[tuple[str, str]] = deque()  # newest first

    def _evict(self) -> None:
        while self.size > self.max_size:
            name, value = self.table.pop()
            self.size -= _entry_size(name, value)

    def _add(self, name: str, value: str) -> None:
        size = _entry_size(name, value)
        if size > self.max_size:
            self.table.clear()
            self.size = 0
            return
        self.table.appendleft((name, value))
        self.size += size
        self._evict()

    def _get(self, index: int) -> tuple[str, str]:
        if index == 0:
            raise HpackError("index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        dynamic = index - len(STATIC_TABLE) - 1
        if dynamic >= len(self.table):
            raise HpackError(f"index {index} past the tables")
        return self.table[dynamic]

    def decode(self, block: bytes) -> list[tuple[str, str]]:
        headers: list[tuple[str, str]] = []
        pos = 0
        while pos < len(block):
            byte = block[pos]
            if byte & 0x80:  # indexed
                index, pos = decode_integer(block, pos, 7)
                headers.append(self._get(index))
                continue
            if byte & 0xE0 == 0x20:  # dynamic table size update
                if headers:
                    raise HpackError("table size update after a header field")
                size, pos = decode_integer(block, pos, 5)
                if size > self.settings_limit:
                    raise HpackError(f"table size {size} over the limit {self.settings_limit}")
                self.max_size = size
                self._evict()
                continue
            if byte & 0xC0 == 0x40:  # literal with incremental indexing
                index, pos = decode_integer(block, pos, 6)
                indexing = True
            else:  # without indexing (0000) or never indexed (0001)
                index, pos = decode_integer(block, pos, 4)
                indexing = False
            if index:
                name = self._get(index)[0]
            else:
                name, pos = _decode_string(block, pos)
            value, pos = _decode_string(block, pos)
            if indexing:
                self._add(name, value)
            headers.append((name, value))
        return headers


def encode(headers) -> bytes:
    """Literals without indexing and without Huffman code (RFC 7541 6.2.2):
    no dynamic table, so nothing the peer's SETTINGS can change."""
    out = bytearray()
    for name, value in headers:
        raw_name = name.encode("latin-1")
        raw_value = value.encode("latin-1")
        out.append(0x00)
        out += encode_integer(len(raw_name), 7)
        out += raw_name
        out += encode_integer(len(raw_value), 7)
        out += raw_value
    return bytes(out)
