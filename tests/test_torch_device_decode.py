"""Device decode in the port against the JAX package, bit for bit.

* The coefficient extractor (``native/ldt_coeffs.cpp``, no libjpeg) against
  the JAX package's libjpeg extractor (``batch_probe_jpeg`` /
  ``batch_extract_coeffs``): probe geometry, ``failed`` and all five pages,
  on a seeded corpus (baseline 4:2:0 at three qualities and without its
  Huffman tables, progressive,
  restart markers, grayscale, odd sizes, 4:4:4 and 4:2:2, 16-bit quant
  tables, payloads cut short, garbage, a noise image of the classification
  set) and on seeded mutations of it; and on arithmetic-coded files (SOF9
  and SOF10) that libjpeg writes here from that corpus through a small
  transcoder compiled with ``g++ -ljpeg``, and on their mutations.
* ``decode_coeff_batch_reference`` against the JAX ``decode_coeff_batch``.
* ``CoeffImageDecoder`` against the JAX one on one Arrow table, with a
  re-encoded and a corrupt row.
* The transform stage, and (``cuda``-marked, skipped without a card) K2
  against its plain version on the card.

The JAX extractor is built privately for this module (its own build links
every process into one shared temp file, which concurrent workers break).
"""

import io
import re
import subprocess
import types
from pathlib import Path

import numpy as np
import pyarrow as pa
import pytest
import torch

from lance_distributed_training_tpu_torch import ops
from lance_distributed_training_tpu_torch.data import (
    CoeffImageDecoder,
    Dataset,
    create_synthetic_classification_dataset,
    decoder_for_task,
)
from lance_distributed_training_tpu_torch.native import coeffs
from lance_distributed_training_tpu_torch.ops import jpeg_device
from test_torch_threads import _one_torch_thread  # noqa: F401
from torch_jax_native import private_jax_native


PAGE_KEYS = jpeg_device.COEFF_KEYS


def _jpeg(arr, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _smooth(rng, h, w, channels=3):
    """A gradient with noise: real images' mix of low and high
    frequencies."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * (c + 1) * 3 + y * 2 * (c + 1)) % 256
                     for c in range(channels)], -1)
    arr = np.clip(base + rng.integers(-30, 30, base.shape), 0, 255)
    arr = arr.astype(np.uint8)
    return arr if channels == 3 else arr[..., 0]


def _noise(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _without_dht(data: bytes) -> bytes:
    """The JPEG with its Huffman tables taken out: decoders fall back to
    the standard tables, which the encoder used."""
    out, i = bytearray(data[:2]), 2
    while data[i + 1] != 0xDA:
        length = (data[i + 2] << 8) | data[i + 3]
        if data[i + 1] != 0xC4:
            out += data[i:i + 2 + length]
        i += 2 + length
    return bytes(out + data[i:])


def _corpus() -> dict:
    rng = np.random.default_rng(0)
    out = {f"baseline_q{q}": _jpeg(_smooth(rng, 64, 48), quality=q)
           for q in (10, 85, 95)}
    out["baseline_no_dht"] = _without_dht(out["baseline_q85"])
    out["progressive"] = _jpeg(_smooth(rng, 80, 72), quality=85,
                               progressive=True)
    out["progressive_noise"] = _jpeg(_noise(rng, 97, 225), quality=90,
                                     progressive=True)
    out["restart_blocks"] = _jpeg(_smooth(rng, 64, 80), quality=85,
                                  restart_marker_blocks=3)
    out["restart_rows"] = _jpeg(_smooth(rng, 70, 50), quality=85,
                                restart_marker_rows=1)
    out["progressive_restart"] = _jpeg(_smooth(rng, 64, 80), quality=75,
                                       progressive=True,
                                       restart_marker_blocks=2)
    out["gray"] = _jpeg(_smooth(rng, 40, 33, 1), quality=85)
    out["gray_progressive"] = _jpeg(_smooth(rng, 41, 30, 1), quality=85,
                                    progressive=True)
    out["odd_225x97"] = _jpeg(_smooth(rng, 97, 225), quality=85)
    out["odd_17x33"] = _jpeg(_smooth(rng, 33, 17), quality=85)
    out["subsampling_444"] = _jpeg(_smooth(rng, 32, 40), quality=85,
                                   subsampling=0)
    out["subsampling_422"] = _jpeg(_smooth(rng, 32, 40), quality=85,
                                   subsampling=1)
    out["quant_16bit"] = _jpeg(_noise(rng, 40, 40), qtables=[
        [300 + i for i in range(64)], [1000 + 7 * i for i in range(64)]])
    for name, kw in (("cut60", {}), ("progressive_cut60",
                                    {"progressive": True}),
                     ("restart_cut60", {"restart_marker_blocks": 2})):
        full = _jpeg(_noise(rng, 96, 96), quality=85, **kw)
        out[name] = full[:int(0.6 * len(full))]
    out["garbage"] = rng.integers(0, 256, 500, dtype=np.uint8).tobytes()
    out["empty"] = b""
    return out


CASES = ["baseline_q10", "baseline_q85", "baseline_q95", "baseline_no_dht",
         "progressive",
         "progressive_noise", "restart_blocks", "restart_rows",
         "progressive_restart", "gray", "gray_progressive", "odd_225x97",
         "odd_17x33", "subsampling_444", "subsampling_422", "quant_16bit",
         "cut60", "progressive_cut60", "restart_cut60", "garbage", "empty",
         "classification_noise_38kb"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    out = _corpus()
    path = tmp_path_factory.mktemp("food") / "food"
    create_synthetic_classification_dataset(str(path), rows=1,
                                            num_classes=101, image_size=224)
    out["classification_noise_38kb"] = Dataset(path).take(
        [0]).column("image")[0].as_py()
    assert sorted(out) == sorted(CASES)
    assert 30_000 < len(out["classification_noise_38kb"]) < 45_000
    return out


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    """The JAX package's extractor (built privately), device decoder and
    K2, with jax.numpy."""
    jax = pytest.importorskip("jax")
    from lance_distributed_training_tpu.data import (
        device_decode as jax_device_decode,
    )
    from lance_distributed_training_tpu.ops import (
        jpeg_device as jax_jpeg_device,
    )

    with private_jax_native(tmp_path_factory.mktemp("jax_native")) \
            as jax_jpeg:
        yield types.SimpleNamespace(jnp=jax.numpy, native=jax_jpeg,
                                    device_decode=jax_device_decode,
                                    ops=jax_jpeg_device)


def _grid(geom):
    yb_h = int(max(1, (geom[:, 1].max() + 7) // 8))
    yb_w = int(max(1, (geom[:, 0].max() + 7) // 8))
    return yb_h, yb_w, (yb_h + 1) // 2, (yb_w + 1) // 2


def _extract(module, payloads, grid, n_threads=0):
    n = len(payloads)
    yb_h, yb_w, cb_h, cb_w = grid
    pages = [np.zeros((n, yb_h, yb_w, 64), np.int16),
             np.zeros((n, cb_h, cb_w, 64), np.int16),
             np.zeros((n, cb_h, cb_w, 64), np.int16),
             np.zeros((n, 3, 64), np.int32), np.zeros((n, 6), np.int32)]
    failed = module.batch_extract_coeffs(module.payload_pointers(payloads),
                                         *grid, *pages, n_threads=n_threads)
    return failed, pages


def _assert_extractors_agree(jx, payloads, n_threads=0):
    want_geom, want_failed = jx.native.batch_probe_jpeg(
        jx.native.payload_pointers(payloads))
    got_geom, got_failed = coeffs.batch_probe_jpeg(
        coeffs.payload_pointers(payloads))
    np.testing.assert_array_equal(got_geom, want_geom)
    np.testing.assert_array_equal(got_failed, want_failed)
    grid = _grid(np.where(want_failed[:, None], 0, want_geom))
    want_bad, want = _extract(jx.native, payloads, grid, n_threads)
    got_bad, got = _extract(coeffs, payloads, grid, n_threads)
    np.testing.assert_array_equal(got_bad, want_bad)
    for key, g, w in zip(PAGE_KEYS, got, want):
        np.testing.assert_array_equal(g, w, err_msg=key)
    return got_geom, got_bad


@pytest.mark.parametrize("case", CASES)
def test_extractor_matches_libjpeg_bit_for_bit(jx, corpus, case):
    geom, failed = _assert_extractors_agree(jx, [corpus[case]])
    ok = case not in ("garbage", "empty")
    assert failed[0] == (not ok or case.startswith("subsampling"))
    assert geom[0, 3] == (ok and not case.startswith("subsampling"))


def test_extractor_matches_libjpeg_on_the_whole_corpus_in_threads(jx, corpus):
    payloads = [corpus[c] for c in CASES] * 3
    for n_threads in (1, 4):
        _assert_extractors_agree(jx, payloads, n_threads)


def test_extractor_matches_libjpeg_on_mutated_payloads(jx, corpus):
    """Seeded truncations, bit flips, overwritten and inserted bytes in the
    entropy-coded data and the headers."""
    rng = np.random.default_rng(1)
    base = [corpus[c] for c in CASES if c not in ("garbage", "empty")]
    mutated = []
    for _ in range(240):
        d = bytearray(base[rng.integers(len(base))])
        kind = rng.integers(4)
        if kind == 0:
            d = d[:rng.integers(2, len(d))]
        elif kind == 1:
            for _ in range(rng.integers(1, 6)):
                d[rng.integers(len(d) // 3, len(d))] ^= 1 << rng.integers(8)
        elif kind == 2:
            for _ in range(rng.integers(1, 4)):
                d[rng.integers(2, len(d))] = rng.integers(256)
        else:
            at = rng.integers(len(d) // 2, len(d))
            d[at:at] = rng.integers(0, 256, rng.integers(1, 40),
                                    dtype=np.uint8).tobytes()
        mutated.append(bytes(d))
    _, failed = _assert_extractors_agree(jx, mutated)
    assert 0 < failed.sum() < len(mutated)


def test_arithmetic_coding_is_a_known_divergence(jx, corpus):
    """Arithmetic-coded frames extract as libjpeg extracts them. Here a
    baseline Huffman frame relabelled SOF9: libjpeg decodes its bytes as
    arithmetic-coded data (garbage), and the port gives the same garbage.
    (The name is the one this test had while the port flagged such
    frames.)"""
    data = bytearray(corpus["baseline_q85"])
    at = data.index(b"\xff\xc0")
    data[at + 1] = 0xC9
    geom, failed = _assert_extractors_agree(jx, [bytes(data)])
    assert geom[0, 3] == 1 and not failed[0]


# A transcoder to arithmetic coding through the machine's libjpeg:
# jpeg_read_coefficients, arith_code = TRUE (and jpeg_simple_progression
# for SOF10), jpeg_write_coefficients. The coefficients do not change.
_TO_ARITH = r"""
#include <cstdio>
#include <cstdlib>
extern "C" {
#include <jpeglib.h>
}
int main(int argc, char** argv) {
  if (argc != 5) return 2;
  FILE* in = std::fopen(argv[1], "rb");
  FILE* out = std::fopen(argv[2], "wb");
  if (!in || !out) return 3;
  jpeg_decompress_struct src;
  jpeg_compress_struct dst;
  jpeg_error_mgr e1, e2;
  src.err = jpeg_std_error(&e1);
  jpeg_create_decompress(&src);
  jpeg_stdio_src(&src, in);
  jpeg_read_header(&src, TRUE);
  jvirt_barray_ptr* coefs = jpeg_read_coefficients(&src);
  dst.err = jpeg_std_error(&e2);
  jpeg_create_compress(&dst);
  jpeg_stdio_dest(&dst, out);
  jpeg_copy_critical_parameters(&src, &dst);
  dst.arith_code = TRUE;
  if (std::atoi(argv[3])) jpeg_simple_progression(&dst);
  dst.restart_interval = static_cast<unsigned>(std::atoi(argv[4]));
  jpeg_write_coefficients(&dst, coefs);
  jpeg_finish_compress(&dst);
  jpeg_destroy_compress(&dst);
  jpeg_finish_decompress(&src);
  jpeg_destroy_decompress(&src);
  std::fclose(in);
  std::fclose(out);
  return 0;
}
"""

# (corpus case, progressive, restart interval in MCUs)
ARITH_CASES = [
    ("baseline_q85", 0, 0), ("baseline_q85", 1, 0), ("baseline_q10", 0, 0),
    ("baseline_q95", 1, 0), ("progressive_noise", 0, 0),
    ("progressive_noise", 1, 0), ("restart_blocks", 0, 3),
    ("restart_blocks", 1, 2), ("gray", 0, 0), ("gray_progressive", 1, 0),
    ("odd_225x97", 1, 5), ("odd_17x33", 0, 1), ("quant_16bit", 0, 0),
    ("quant_16bit", 1, 0), ("classification_noise_38kb", 1, 0),
    ("subsampling_444", 0, 0),
]


def _arith_id(case) -> str:
    name, progressive, restart = case
    return f"{name}_sof{10 if progressive else 9}_r{restart}"


@pytest.fixture(scope="module")
def arith_corpus(tmp_path_factory, corpus):
    """The ARITH_CASES transcoded by libjpeg, by id."""
    root = tmp_path_factory.mktemp("arith")
    (root / "to_arith.cpp").write_text(_TO_ARITH)
    tool = root / "to_arith"
    subprocess.run(["g++", "-O1", "-o", str(tool), str(root / "to_arith.cpp"),
                    "-ljpeg"], check=True, capture_output=True, timeout=120)
    out = {}
    for case in ARITH_CASES:
        name, progressive, restart = case
        src, dst = root / f"{name}.jpg", root / f"{_arith_id(case)}.jpg"
        src.write_bytes(corpus[name])
        subprocess.run([str(tool), str(src), str(dst), str(progressive),
                        str(restart)], check=True, capture_output=True,
                       timeout=60)
        data = dst.read_bytes()
        sof = 0xCA if progressive else 0xC9
        assert bytes([0xFF, sof]) in data and b"\xff\xcc" in data  # DAC
        out[_arith_id(case)] = data
    return out


@pytest.mark.parametrize("case", [_arith_id(c) for c in ARITH_CASES])
def test_arithmetic_coded_files_match_libjpeg(jx, arith_corpus, case):
    geom, failed = _assert_extractors_agree(jx, [arith_corpus[case]])
    assert not failed[0] or case.startswith("subsampling")
    assert geom[0, 3] == (not case.startswith("subsampling"))


def test_arithmetic_coded_mutations_match_libjpeg(jx, arith_corpus):
    """Seeded truncations, bit flips, overwritten and inserted bytes of the
    arithmetic-coded files, the DAC segments included."""
    rng = np.random.default_rng(2)
    base = list(arith_corpus.values())
    mutated = []
    for _ in range(240):
        d = bytearray(base[rng.integers(len(base))])
        kind = rng.integers(5)
        if kind == 0:
            d = d[:rng.integers(2, len(d))]
        elif kind == 1:
            for _ in range(rng.integers(1, 6)):
                d[rng.integers(len(d) // 3, len(d))] ^= 1 << rng.integers(8)
        elif kind == 2:
            for _ in range(rng.integers(1, 4)):
                d[rng.integers(2, len(d))] = rng.integers(256)
        elif kind == 3:
            at = rng.integers(len(d) // 2, len(d))
            d[at:at] = rng.integers(0, 256, rng.integers(1, 40),
                                    dtype=np.uint8).tobytes()
        else:
            at = bytes(d).find(b"\xff\xcc")  # a DAC byte
            d[at + 2 + rng.integers(0, 4)] = rng.integers(256)
        mutated.append(bytes(d))
    _, failed = _assert_extractors_agree(jx, mutated)
    assert 0 < failed.sum() < len(mutated)


def test_coeff_decoder_takes_arithmetic_rows_without_reencoding(
        jx, arith_corpus):
    """CoeffImageDecoder extracts arithmetic-coded rows itself, as the JAX
    decoder (through libjpeg) does."""
    payloads = [arith_corpus[_arith_id(c)] for c in ARITH_CASES
                if not c[0].startswith("subsampling")]
    table = pa.table({"image": pa.array(payloads, pa.binary()),
                      "label": pa.array(np.arange(len(payloads)),
                                        pa.int64())})
    want = jx.device_decode.CoeffImageDecoder(image_size=32)(table)
    got_dec = CoeffImageDecoder(image_size=32)
    got = got_dec(table)
    assert got_dec.reencoded == 0 and got_dec.undecodable == 0
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_extractor_checks_its_pages(corpus):
    payloads = [corpus["baseline_q85"]]
    with pytest.raises(ValueError, match="coef_y shape"):
        coeffs.batch_extract_coeffs(
            coeffs.payload_pointers(payloads), 8, 6, 4, 3,
            np.zeros((1, 8, 5, 64), np.int16),
            np.zeros((1, 4, 3, 64), np.int16),
            np.zeros((1, 4, 3, 64), np.int16),
            np.zeros((1, 3, 64), np.int32), np.zeros((1, 6), np.int32))
    assert coeffs.default_threads() >= 1


# ------------------------------------------------------------- K2 (plain)


def _random_pages(seed, n, ybh, ybw, big=False):
    """Random pages with a zero-geometry row, a grayscale row (zero
    chroma), odd real extents and, with ``big``, 16-bit quant tables and
    full-range coefficients that wrap int32 in the IDCT."""
    rng = np.random.default_rng(seed)
    cbh, cbw = (ybh + 1) // 2, (ybw + 1) // 2
    lim = 32768 if big else 2048
    pages = {
        "jpeg_coef_y": rng.integers(-lim, lim, (n, ybh, ybw, 64)),
        "jpeg_coef_cb": rng.integers(-1024, 1024, (n, cbh, cbw, 64)),
        "jpeg_coef_cr": rng.integers(-1024, 1024, (n, cbh, cbw, 64)),
        "jpeg_quant": rng.integers(1, 65536 if big else 100, (n, 3, 64)),
        "jpeg_geom": np.zeros((n, 6)),
    }
    for k in PAGE_KEYS:
        pages[k] = pages[k].astype(np.int16 if "coef" in k else np.int32)
    geom = pages["jpeg_geom"]
    geom[:, 0] = rng.integers(1, ybw * 8 + 1, n)
    geom[:, 1] = rng.integers(1, ybh * 8 + 1, n)
    geom[0] = 0
    pages["jpeg_coef_cb"][1] = pages["jpeg_coef_cr"][1] = 0
    return pages


def _jax_decode(jx, pages, size):
    return np.asarray(jx.ops.decode_coeff_batch(
        *[jx.jnp.asarray(pages[k]) for k in PAGE_KEYS], out_size=size))


def _port_decode(pages, size):
    return jpeg_device.decode_coeff_batch(
        *[torch.from_numpy(pages[k]) for k in PAGE_KEYS],
        out_size=size).numpy()


def test_idct_basis_and_constants_are_the_jax_modules(jx):
    np.testing.assert_array_equal(jpeg_device.IDCT_BASIS_FIX,
                                  jx.ops.IDCT_BASIS_FIX)
    assert jpeg_device.COEFF_KEYS == jx.ops.COEFF_KEYS
    assert (jpeg_device.HOST_PARITY_MAX_ABS_DIFF
            == jx.ops.HOST_PARITY_MAX_ABS_DIFF)


@pytest.mark.parametrize("size", [32, 24, 40])
@pytest.mark.parametrize("grid", [(4, 3), (5, 7), (2, 2)])
def test_plain_k2_matches_jax_bit_for_bit(jx, size, grid):
    pages = _random_pages(size + grid[0], 5, *grid)
    want = _jax_decode(jx, pages, size)
    got = _port_decode(pages, size)
    assert got.dtype == np.uint8 and got.shape == (5, size, size, 3)
    np.testing.assert_array_equal(got, want)


def test_plain_k2_matches_jax_where_int32_wraps(jx):
    """16-bit quant tables and full-range coefficients overflow int32 in
    the IDCT; geometry past the plane and past 2^15 exercises the gather's
    clamp and the wrapped ratio."""
    pages = _random_pages(9, 4, 4, 4, big=True)
    pages["jpeg_geom"][2, :2] = [4 * 8 + 37, 40000]
    pages["jpeg_geom"][3, :2] = [65535, 1]
    for size in (32, 1):
        np.testing.assert_array_equal(_port_decode(pages, size),
                                      _jax_decode(jx, pages, size))


def test_plain_k2_matches_jax_on_extracted_pages(jx, corpus):
    payloads = [corpus[c] for c in CASES]
    pages = dict(zip(PAGE_KEYS, _extract(
        coeffs, payloads, _grid(coeffs.batch_probe_jpeg(
            coeffs.payload_pointers(payloads))[0]))[1]))
    for size in (48, 224):
        np.testing.assert_array_equal(_port_decode(pages, size),
                                      _jax_decode(jx, pages, size))


def test_kernel_basis_table_is_the_idct_basis():
    """The CUDA source holds the IDCT basis as a constant table (the
    kernel cannot be compiled here): it must be IDCT_BASIS_FIX, row for
    row."""
    source = (Path(jpeg_device.__file__).parent / "csrc" /
              "jpeg_decode.cu").read_text()
    table = re.search(r"kBasis\[64\] = \{([^}]*)\}", source).group(1)
    values = [int(x) for x in table.replace("\n", " ").split(",") if x.strip()]
    np.testing.assert_array_equal(np.array(values).reshape(8, 8),
                                  jpeg_device.IDCT_BASIS_FIX)


def test_even_odd_idct_sums_give_the_plain_bits():
    """The kernel's IDCT sums the basis's even and odd terms apart in each
    pass (B[7 - x][u] = (-1)^u B[x][u]), half the products of the matrix
    form. In wrapping 32-bit arithmetic those are the same sums, so the
    bits match the plain version, int32 wrap-around included; written out
    here in numpy as the kernel orders it."""
    rng = np.random.default_rng(7)
    n, mask = 256, 0xFFFFFFFF
    coef = rng.integers(-32768, 32768, (n, 1, 1, 64)).astype(np.int16)
    quant = rng.integers(1, 65536, (n, 64)).astype(np.int32)
    want = jpeg_device._idct_plane(torch.from_numpy(coef),
                                   torch.from_numpy(quant)).numpy()
    basis = jpeg_device.IDCT_BASIS_FIX.astype(np.int64)
    assert (basis[::-1] == basis * (-1) ** np.arange(8)).all()

    def descale(x):  # (x + 1024) >> 11 on int32, from uint32 bits
        x = (x + 1024) & mask
        return np.where(x >= 2 ** 31, x - 2 ** 32, x) >> 11

    c = (coef.reshape(n, 8, 8).astype(np.int64)
         * quant.reshape(n, 8, 8).astype(np.int64)) & mask  # [n, u, v]
    s1 = np.zeros((n, 8, 8), np.int64)  # [n, u, y]
    for y in range(4):
        even = (c[:, :, 0::2] * basis[y, 0::2]).sum(-1) & mask
        odd = (c[:, :, 1::2] * basis[y, 1::2]).sum(-1) & mask
        s1[:, :, y], s1[:, :, 7 - y] = descale(even + odd), descale(even - odd)
    s1 &= mask
    got = np.zeros((n, 8, 8), np.int64)  # [n, x, y]
    for x in range(4):
        even = (basis[x, 0::2, None] * s1[:, 0::2, :]).sum(1) & mask
        odd = (basis[x, 1::2, None] * s1[:, 1::2, :]).sum(1) & mask
        for row, total in ((x, even + odd), (7 - x, even - odd)):
            got[:, row] = np.clip(descale(total) + 128, 0, 255)
    np.testing.assert_array_equal(got, want.reshape(n, 8, 8))


def _wide_pages(seed, ybh, ybw):
    """Four images' random pages on a grid wide enough for the kernel to
    hold only the block columns a tile samples (and, at large sizes, to
    split the output into column tiles): real widths of the whole grid,
    of all but 5 pixels, of 33 pixels, and past 2^15, whose wrapped ratio
    samples backwards."""
    pages = _random_pages(seed, 4, ybh, ybw)
    pages["jpeg_geom"][:, 0] = [ybw * 8, ybw * 8 - 5, 33, 40000]
    return pages


@pytest.mark.parametrize("grid,size", [
    ((1, 900), 16),   # wider than a whole block row of shared memory
    ((2, 300), 24),
    ((1, 130), 40),
    ((3, 64), 8),
    ((1, 1100), 1),
    ((1, 600), 32),
    ((2, 257), 33),
])
def test_plain_k2_matches_jax_on_wide_grids(jx, grid, size):
    pages = _wide_pages(grid[1], *grid)
    np.testing.assert_array_equal(_port_decode(pages, size),
                                  _jax_decode(jx, pages, size))


def test_k2_rejects_other_devices_and_counts_no_cpu_launch():
    pages = _random_pages(3, 2, 2, 2)
    args = [torch.from_numpy(pages[k]) for k in PAGE_KEYS]
    before = ops.LAUNCHES["jpeg_decode"]
    jpeg_device.decode_coeff_batch(*args, out_size=8)
    assert ops.LAUNCHES["jpeg_decode"] == before  # the CPU runs the plain one
    with pytest.raises(RuntimeError, match="no kernel for device meta"):
        jpeg_device.decode_coeff_batch(*[a.to("meta") for a in args])


# --------------------------------------------------------- host decoder


@pytest.fixture(scope="module")
def image_table(tmp_path_factory, corpus):
    """A small classification table plus a 4:4:4 row (re-encoded by both
    decoders), a corrupt row (a zeroed page) and a grayscale row."""
    path = tmp_path_factory.mktemp("coeff") / "food"
    create_synthetic_classification_dataset(str(path), rows=9, num_classes=5,
                                            image_size=40, unique_images=4,
                                            seed=2)
    table = Dataset(path).take(np.arange(9))
    images = table.column("image").to_pylist()
    images[2] = corpus["subsampling_444"]
    images[5] = corpus["garbage"]
    images[7] = corpus["gray"]
    return pa.table({"image": pa.array(images, pa.binary()),
                     "label": table.column("label")})


@pytest.mark.parametrize("chunk", [1, 4])
def test_coeff_decoder_matches_jax_decoder(jx, image_table, chunk):
    want_dec = jx.device_decode.CoeffImageDecoder(image_size=40,
                                                  chunk_blocks=chunk)
    got_dec = CoeffImageDecoder(image_size=40, chunk_blocks=chunk)
    want, got = want_dec(image_table), got_dec(image_table)
    assert sorted(got) == sorted(want) == sorted(PAGE_KEYS + ("label",))
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got_dec.reencoded == 1 and got_dec.undecodable == 1
    np.testing.assert_array_equal(got["jpeg_geom"][5], 0)
    np.testing.assert_array_equal(got["jpeg_quant"][5], 1)
    assert got_dec.arm == "coeff" and len(got_dec.entropy_ms) == 1
    assert got_dec.threads == coeffs.default_threads()
    # The per-payload entry point gives the same pages as the column one.
    payloads = image_table.column("image").to_pylist()
    again = got_dec.decode_payloads(payloads)
    for key in PAGE_KEYS:
        np.testing.assert_array_equal(again[key], want[key], err_msg=key)
    # And the pixels the two K2s make of them agree.
    np.testing.assert_array_equal(_port_decode(got, 40),
                                  _jax_decode(jx, want, 40))


def test_coeff_decoder_grid_grows_monotonically_in_chunks(corpus):
    dec = CoeffImageDecoder(image_size=32, chunk_blocks=4)
    small = dec.decode_payloads([corpus["odd_17x33"]])
    assert small["jpeg_coef_y"].shape[1:3] == (8, 4)
    assert small["jpeg_coef_cb"].shape[1:3] == (4, 2)
    big = dec.decode_payloads([corpus["odd_225x97"]])
    assert big["jpeg_coef_y"].shape[1:3] == (16, 32)
    again = dec.decode_payloads([corpus["odd_17x33"]])
    assert again["jpeg_coef_y"].shape[1:3] == (16, 32)  # never shrinks
    np.testing.assert_array_equal(again["jpeg_geom"], small["jpeg_geom"])
    empty = dec.decode_payloads([])
    assert empty["jpeg_coef_y"].shape == (0, 16, 32, 64)
    assert dec.set_chunk(0) == 1
    assert "chunk=1" in dec.cache_fingerprint()


def test_decoder_for_task_gives_the_coeff_decoder():
    dec = decoder_for_task("classification", image_size=48,
                           device_decode=True)
    assert isinstance(dec, CoeffImageDecoder)
    assert dec.arm == "coeff" and dec.image_size == 48
    assert dec.required_columns == ["image", "label"]
    with pytest.raises(TypeError, match="binary"):
        dec.decode_column(pa.array([1, 2]))


# ------------------------------------------------------ transform stage


def test_transform_passes_pixel_batches_and_weights_through():
    transform = jpeg_device.make_batch_transform(16)
    pixels = {"image": torch.zeros((2, 16, 16, 3), dtype=torch.uint8),
              "label": torch.tensor([1, 2])}
    assert transform(pixels) is pixels
    assert not jpeg_device.is_coeff_batch(pixels)
    pages = _random_pages(4, 3, 2, 2)
    batch = {k: torch.from_numpy(v) for k, v in pages.items()}
    batch["label"] = torch.tensor([0, 1, 2])
    batch["_weight"] = torch.tensor([1.0, 1.0, 0.0])
    assert jpeg_device.is_coeff_batch(batch)
    out = transform(batch)
    assert sorted(out) == ["_weight", "image", "label"]
    assert out["label"] is batch["label"] and out["_weight"] is batch[
        "_weight"]
    np.testing.assert_array_equal(out["image"].numpy(), _port_decode(pages,
                                                                     16))


# -------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _on(pages, device):
    return [torch.from_numpy(pages[k]).to(device) for k in PAGE_KEYS]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["path", "ragged", "wrap", "grid_64",
                                  "extracted", "wide"])
@pytest.mark.parametrize("size", [224, 32, 40])
def test_kernel_matches_plain_on_card(cuda_device, corpus, case, size):
    """The fused kernel against the plain version, bit for bit, at the
    path's grid, ragged grids, int32 wrap-around, a 64 x 64 block grid
    (512-pixel images, the size of real photographs, scaled down), a grid
    1000 blocks wide (8000-pixel panoramas) and the
    extractor's pages of the corpus's odd, grayscale, progressive and
    re-encoded files."""
    if case == "path":
        pages = _random_pages(0, 64, 28, 28)
    elif case == "ragged":
        pages = _random_pages(1, 7, 5, 3)
    elif case == "grid_64":
        pages = _random_pages(4, 6, 64, 64)
        pages["jpeg_geom"][2:, :2] = [[512, 512], [500, 317], [33, 511],
                                      [512, 1]]
    elif case == "wide":
        pages = _wide_pages(6, 2, 1000)
    elif case == "extracted":
        payloads = [corpus[c] for c in CASES]
        pages = dict(zip(PAGE_KEYS, _extract(
            coeffs, payloads, _grid(coeffs.batch_probe_jpeg(
                coeffs.payload_pointers(payloads))[0]))[1]))
    else:
        pages = _random_pages(2, 5, 4, 4, big=True)
        pages["jpeg_geom"][2, :2] = [4 * 8 + 37, 40000]
        pages["jpeg_geom"][3, :2] = [65535, 1]
    args = _on(pages, cuda_device)
    before = ops.LAUNCHES["jpeg_decode"]
    got = jpeg_device.decode_coeff_batch(*args, out_size=size)
    want = jpeg_device.decode_coeff_batch_reference(*args, out_size=size)
    again = jpeg_device.decode_coeff_batch(*args, out_size=size)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["jpeg_decode"] == before + 2
    assert torch.equal(got, want) and torch.equal(got, again)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _port_decode(pages, size))


@pytest.mark.cuda
@pytest.mark.parametrize("ybw,size", [(1024, 512), (2000, 300)])
def test_kernel_matches_plain_on_card_in_column_tiles(cuda_device, ybw,
                                                      size):
    """Grids so wide at these sizes that a tile of the whole output row
    does not fit shared memory: the kernel splits each band into column
    tiles (at 300 pixels, tiles whose rows are not 16-byte multiples)."""
    pages = _wide_pages(ybw, 2, ybw)
    args = _on(pages, cuda_device)
    got = jpeg_device.decode_coeff_batch(*args, out_size=size)
    want = jpeg_device.decode_coeff_batch_reference(*args, out_size=size)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    args = _on(_random_pages(3, 2, 2, 2), cuda_device)
    with pytest.raises(TypeError):
        jpeg_device.decode_coeff_batch(args[0].int(), *args[1:])
    with pytest.raises(ValueError, match="chroma grid"):
        jpeg_device.decode_coeff_batch(args[0], args[1][:, :0], args[2][:, :0],
                                       *args[3:])
    with pytest.raises(ValueError, match="quant"):
        jpeg_device.decode_coeff_batch(*args[:3], args[3][:, :2], args[4])
    widest = jpeg_device._library().ldt_jpeg_widest_grid(224)
    assert widest > 8192  # JPEG's own limit: 65535 pixels
    wide = [t[:1] for t in _on(_random_pages(3, 2, 1, 1), cuda_device)]
    wide[0] = torch.zeros((1, 1, widest + 1, 64), dtype=torch.int16,
                          device=cuda_device)
    wide[1] = wide[2] = torch.zeros((1, 1, (widest + 2) // 2, 64),
                                    dtype=torch.int16, device=cuda_device)
    with pytest.raises(ValueError, match=f"the widest 4:2:0 grid that does "
                                         f"is {widest} blocks"):
        jpeg_device.decode_coeff_batch(*wide)
