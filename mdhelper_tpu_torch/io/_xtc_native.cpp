// Native XTC (xdr3dfcoord) codec — the hot bit-level inner loops of
// mdhelper_tpu_torch/io/xtc.py in C++ (the Python module is the portable
// reference implementation; this library is built on demand with g++
// and loaded via ctypes, mirroring how the reference ships native
// helpers for its hot paths).  Implements the public GROMACS XTC
// payload format: fixed-point quantization, multi-radix packed
// integers, adaptive small-difference run-length coding.
//
// Exported C ABI:
//   xtc_decompress(data, size, natoms, out_coords, out_precision)
//       -> bytes consumed, or -1 on error
//   xtc_compress(coords, natoms, precision, out, out_cap)
//       -> bytes written, or -1 on error
// Both operate on the payload that follows the natoms word of a
// frame (precision, bounds, smallidx, byte count, packed bits); the
// <=9-atom raw-float form is handled by the Python layer.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdlib>

namespace {

const int MAGICINTS[] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50,
    64, 80, 101, 128, 161, 203, 256, 322, 406, 512, 645, 812,
    1024, 1290, 1625, 2048, 2580, 3250, 4096, 5060, 6501, 8192,
    10321, 13003, 16384, 20642, 26007, 32768, 41285, 52015, 65536,
    82570, 104031, 131072, 165140, 208063, 262144, 330280, 416127,
    524287, 660561, 832255, 1048576, 1321122, 1664510, 2097152,
    2642245, 3329021, 4194304, 5284491, 6658042, 8388607,
    10568983, 13316085, 16777216};
const int FIRSTIDX = 9;
const int LASTIDX = (int)(sizeof(MAGICINTS) / sizeof(int)) - 1;

struct BitReader {
    const unsigned char *data;
    long nbytes;
    long bitpos;

    unsigned int read(int nbits) {
        unsigned int out = 0;
        while (nbits > 0) {
            long byte_i = bitpos >> 3;
            int bit_o = (int)(bitpos & 7);
            int take = 8 - bit_o;
            if (take > nbits) take = nbits;
            // Corrupt streams must not read out of bounds; zeros
            // past the end surface as a value mismatch upstream.
            unsigned int byte =
                byte_i < nbytes ? data[byte_i] : 0u;
            unsigned int chunk = (byte >> (8 - bit_o - take)) &
                                 ((1u << take) - 1u);
            out = (out << take) | chunk;
            bitpos += take;
            nbits -= take;
        }
        return out;
    }

    void read_ints(int nbits, const unsigned int sizes[3],
                   int nums[3]) {
        unsigned char bytes[32];
        int nb = 0;
        while (nbits > 8) {
            bytes[nb++] = (unsigned char)read(8);
            nbits -= 8;
        }
        if (nbits > 0) bytes[nb++] = (unsigned char)read(nbits);
        for (int i = 2; i > 0; i--) {
            unsigned long num = 0;
            for (int j = nb - 1; j >= 0; j--) {
                num = (num << 8) | bytes[j];
                unsigned long p = num / sizes[i];
                bytes[j] = (unsigned char)p;
                num -= p * sizes[i];
            }
            nums[i] = (int)num;
        }
        nums[0] = bytes[0];
        if (nb > 1) nums[0] |= (int)bytes[1] << 8;
        if (nb > 2) nums[0] |= (int)bytes[2] << 16;
        if (nb > 3) nums[0] |= (int)bytes[3] << 24;
    }
};

struct BitWriter {
    unsigned char *out;
    long cap;
    long cnt;        // full bytes written
    int lastbits;    // pending bit count
    unsigned int acc;  // pending bits (low-aligned)
    bool overflow;

    // Push <= 8 bits (keeps the 32-bit accumulator from
    // overflowing: lastbits stays < 8 between calls).
    void push(int nbits, unsigned int value) {
        acc = (acc << nbits) | value;
        lastbits += nbits;
        if (lastbits >= 8) {
            lastbits -= 8;
            if (cnt >= cap) {
                overflow = true;
                return;
            }
            out[cnt++] = (unsigned char)((acc >> lastbits) & 0xffu);
            acc &= (1u << lastbits) - 1u;
        }
    }

    void write(int nbits, unsigned int value) {
        while (nbits >= 8) {
            push(8, (value >> (nbits - 8)) & 0xffu);
            nbits -= 8;
        }
        if (nbits > 0) push(nbits, value & ((1u << nbits) - 1u));
    }

    void write_ints(int nbits, const unsigned int sizes[3],
                    const unsigned int nums[3]) {
        // Combine into little-endian bytes of
        // (num0 * s1 + num1) * s2 + num2.
        unsigned char bytes[32];
        unsigned long tmp = nums[0];
        int nb = 0;
        do {
            bytes[nb++] = (unsigned char)(tmp & 0xffu);
            tmp >>= 8;
        } while (tmp != 0);
        for (int i = 1; i < 3; i++) {
            unsigned long carry = nums[i];
            int bc;
            for (bc = 0; bc < nb; bc++) {
                carry += (unsigned long)bytes[bc] * sizes[i];
                bytes[bc] = (unsigned char)(carry & 0xffu);
                carry >>= 8;
            }
            while (carry != 0) {
                bytes[bc++] = (unsigned char)(carry & 0xffu);
                carry >>= 8;
            }
            nb = bc;
        }
        if (nbits >= nb * 8) {
            for (int i = 0; i < nb; i++) write(8, bytes[i]);
            write(nbits - nb * 8, 0);
        } else {
            for (int i = 0; i < nb - 1; i++) write(8, bytes[i]);
            write(nbits - (nb - 1) * 8, bytes[nb - 1]);
        }
    }

    long flush() {
        if (lastbits > 0) {
            if (cnt >= cap) {
                overflow = true;
                return -1;
            }
            out[cnt] = (unsigned char)((acc << (8 - lastbits)) & 0xffu);
            return cnt + 1;
        }
        return cnt;
    }
};

int sizeofint(unsigned int size) {
    unsigned int num = 1;
    int nbits = 0;
    while (size >= num && nbits < 32) {
        nbits++;
        num <<= 1;
    }
    return nbits;
}

int sizeofints(const unsigned int sizes[3]) {
    unsigned char bytes[32];
    bytes[0] = 1;
    int nb = 1;
    for (int i = 0; i < 3; i++) {
        unsigned long tmp = 0;
        int bc;
        for (bc = 0; bc < nb; bc++) {
            tmp += (unsigned long)bytes[bc] * sizes[i];
            bytes[bc] = (unsigned char)(tmp & 0xffu);
            tmp >>= 8;
        }
        while (tmp != 0) {
            bytes[bc++] = (unsigned char)(tmp & 0xffu);
            tmp >>= 8;
        }
        nb = bc;
    }
    int num = 1;
    int nbits = 0;
    while (bytes[nb - 1] >= num) {
        nbits++;
        num *= 2;
    }
    return nbits + (nb - 1) * 8;
}

int read_be_i32(const unsigned char *p) {
    return (int)(((unsigned int)p[0] << 24) |
                 ((unsigned int)p[1] << 16) |
                 ((unsigned int)p[2] << 8) | (unsigned int)p[3]);
}

float read_be_f32(const unsigned char *p) {
    unsigned int bits = ((unsigned int)p[0] << 24) |
                        ((unsigned int)p[1] << 16) |
                        ((unsigned int)p[2] << 8) | (unsigned int)p[3];
    float f;
    std::memcpy(&f, &bits, 4);
    return f;
}

void write_be_i32(unsigned char *p, int v) {
    unsigned int u = (unsigned int)v;
    p[0] = (unsigned char)(u >> 24);
    p[1] = (unsigned char)(u >> 16);
    p[2] = (unsigned char)(u >> 8);
    p[3] = (unsigned char)u;
}

void write_be_f32(unsigned char *p, float f) {
    unsigned int u;
    std::memcpy(&u, &f, 4);
    write_be_i32(p, (int)u);
}

}  // namespace

extern "C" {

// Decompress one payload (natoms > 9).  Returns bytes consumed or -1.
long xtc_decompress(const unsigned char *data, long size, int natoms,
                    float *out, float *precision_out) {
    if (size < 36) return -1;
    float precision = read_be_f32(data);
    int minint[3], maxint[3];
    for (int k = 0; k < 3; k++) minint[k] = read_be_i32(data + 4 + 4 * k);
    for (int k = 0; k < 3; k++) maxint[k] = read_be_i32(data + 16 + 4 * k);
    int smallidx = read_be_i32(data + 28);
    long nbytes = (long)read_be_i32(data + 32);
    if (smallidx < FIRSTIDX || smallidx > LASTIDX) return -1;
    if (nbytes < 0 || 36 + nbytes > size) return -1;

    unsigned int sizeint[3], bitsizeint[3];
    for (int k = 0; k < 3; k++)
        sizeint[k] =
            (unsigned int)((long)maxint[k] - (long)minint[k] + 1);
    int bitsize;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffffu) {
        for (int k = 0; k < 3; k++)
            bitsizeint[k] = sizeofint(sizeint[k]);
        bitsize = 0;
    } else {
        bitsize = sizeofints(sizeint);
    }

    int smaller =
        MAGICINTS[FIRSTIDX > smallidx - 1 ? FIRSTIDX : smallidx - 1] /
        2;
    int smallnum = MAGICINTS[smallidx] / 2;
    unsigned int sizesmall[3] = {(unsigned int)MAGICINTS[smallidx],
                                 (unsigned int)MAGICINTS[smallidx],
                                 (unsigned int)MAGICINTS[smallidx]};

    BitReader r{data + 36, nbytes, 0};
    double inv = 1.0 / (double)precision;
    int run = 0;
    int i = 0;
    int prev[3] = {0, 0, 0};
    while (i < natoms) {
        int thiscoord[3];
        if (bitsize == 0) {
            for (int k = 0; k < 3; k++)
                thiscoord[k] = (int)r.read(bitsizeint[k]);
        } else {
            r.read_ints(bitsize, sizeint, thiscoord);
        }
        for (int k = 0; k < 3; k++) thiscoord[k] += minint[k];
        int big_slot = i;
        i++;
        for (int k = 0; k < 3; k++) prev[k] = thiscoord[k];

        unsigned int flag = r.read(1);
        int is_smaller = 0;
        if (flag) {
            unsigned int v = r.read(5);
            is_smaller = (int)(v % 3);
            run = (int)v - is_smaller;
            is_smaller--;
        }
        if (run > 0) {
            bool first = true;
            for (int k3 = 0; k3 < run; k3 += 3) {
                int cur[3];
                r.read_ints(smallidx, sizesmall, cur);
                if (i >= natoms) return -1;
                for (int k = 0; k < 3; k++)
                    cur[k] += prev[k] - smallnum;
                if (first) {
                    // Undo the compressor's first/second interchange.
                    for (int k = 0; k < 3; k++) {
                        int tmp = cur[k];
                        cur[k] = prev[k];
                        prev[k] = tmp;
                    }
                    for (int k = 0; k < 3; k++)
                        out[3 * big_slot + k] =
                            (float)(prev[k] * inv);
                    first = false;
                } else {
                    for (int k = 0; k < 3; k++) prev[k] = cur[k];
                }
                for (int k = 0; k < 3; k++)
                    out[3 * i + k] = (float)(cur[k] * inv);
                i++;
            }
        } else {
            for (int k = 0; k < 3; k++)
                out[3 * big_slot + k] = (float)(thiscoord[k] * inv);
        }
        smallidx += is_smaller;
        if (is_smaller < 0) {
            smallnum = smaller;
            smaller = smallidx > FIRSTIDX
                          ? MAGICINTS[smallidx - 1] / 2
                          : 0;
        } else if (is_smaller > 0) {
            smaller = smallnum;
            smallnum = MAGICINTS[smallidx] / 2;
        }
        if (smallidx < FIRSTIDX || smallidx > LASTIDX) return -1;
        sizesmall[0] = sizesmall[1] = sizesmall[2] =
            (unsigned int)MAGICINTS[smallidx];
    }
    if (precision_out) *precision_out = precision;
    long consumed = 36 + nbytes;
    consumed += (4 - (nbytes & 3)) & 3;
    return consumed;
}

// Compress natoms (>9) double coordinates.  Returns payload bytes
// written to `out` (capacity out_cap) or -1.
long xtc_compress(const double *coords, int natoms, float precision,
                  unsigned char *out, long out_cap) {
    if (out_cap < 40) return -1;
    const double MAXABS = 2147483645.0;  // INT_MAX - 2

    // Quantize (round half away from zero) and find bounds/mindiff.
    int *ip = new int[(size_t)natoms * 3];
    int minint[3] = {2147483647, 2147483647, 2147483647};
    int maxint[3] = {-2147483648 + 1, -2147483648 + 1,
                     -2147483648 + 1};
    long mindiff = 0x7fffffffL;
    int oldl[3] = {0, 0, 0};
    for (int a = 0; a < natoms; a++) {
        long diff = 0;
        for (int k = 0; k < 3; k++) {
            double lf = coords[3 * a + k] * (double)precision;
            lf += (lf >= 0.0) ? 0.5 : -0.5;
            if (std::fabs(lf) > MAXABS) {
                delete[] ip;
                return -1;
            }
            int v = (int)lf;
            ip[3 * a + k] = v;
            if (v < minint[k]) minint[k] = v;
            if (v > maxint[k]) maxint[k] = v;
            diff += std::abs((long)oldl[k] - (long)v);
            oldl[k] = v;
        }
        if (a >= 1 && diff < mindiff) mindiff = diff;
    }
    for (int k = 0; k < 3; k++)
        if ((double)maxint[k] - (double)minint[k] >= MAXABS) {
            delete[] ip;
            return -1;
        }

    unsigned int sizeint[3], bitsizeint[3] = {0, 0, 0};
    for (int k = 0; k < 3; k++)
        sizeint[k] =
            (unsigned int)((long)maxint[k] - (long)minint[k] + 1);
    int bitsize;
    if ((sizeint[0] | sizeint[1] | sizeint[2]) > 0xffffffu) {
        for (int k = 0; k < 3; k++)
            bitsizeint[k] = sizeofint(sizeint[k]);
        bitsize = 0;
    } else {
        bitsize = sizeofints(sizeint);
    }

    int smallidx = FIRSTIDX;
    while (smallidx < LASTIDX && MAGICINTS[smallidx] < mindiff)
        smallidx++;

    write_be_f32(out, precision);
    for (int k = 0; k < 3; k++)
        write_be_i32(out + 4 + 4 * k, minint[k]);
    for (int k = 0; k < 3; k++)
        write_be_i32(out + 16 + 4 * k, maxint[k]);
    write_be_i32(out + 28, smallidx);

    int maxidx = smallidx + 8 < LASTIDX ? smallidx + 8 : LASTIDX;
    int minidx = maxidx - 8;
    int smaller =
        MAGICINTS[FIRSTIDX > smallidx - 1 ? FIRSTIDX : smallidx - 1] /
        2;
    int smallnum = MAGICINTS[smallidx] / 2;
    unsigned int sizesmall[3] = {(unsigned int)MAGICINTS[smallidx],
                                 (unsigned int)MAGICINTS[smallidx],
                                 (unsigned int)MAGICINTS[smallidx]};
    long larger = MAGICINTS[maxidx] / 2;

    BitWriter w{out + 36, out_cap - 40, 0, 0, 0u, false};
    int prev[3] = {0, 0, 0};
    int prevrun = -1;
    int i = 0;
    while (i < natoms) {
        bool is_small = false;
        int *thiscoord = ip + (size_t)i * 3;
        int is_smaller;
        if (smallidx < maxidx && i >= 1 &&
            std::abs((long)thiscoord[0] - prev[0]) < larger &&
            std::abs((long)thiscoord[1] - prev[1]) < larger &&
            std::abs((long)thiscoord[2] - prev[2]) < larger) {
            is_smaller = 1;
        } else if (smallidx > minidx) {
            is_smaller = -1;
        } else {
            is_smaller = 0;
        }
        if (i + 1 < natoms &&
            std::abs((long)thiscoord[0] - thiscoord[3]) < smallnum &&
            std::abs((long)thiscoord[1] - thiscoord[4]) < smallnum &&
            std::abs((long)thiscoord[2] - thiscoord[5]) < smallnum) {
            for (int k = 0; k < 3; k++) {
                int tmp = thiscoord[k];
                thiscoord[k] = thiscoord[k + 3];
                thiscoord[k + 3] = tmp;
            }
            is_small = true;
        }
        unsigned int tmpc[3];
        for (int k = 0; k < 3; k++)
            tmpc[k] = (unsigned int)(thiscoord[k] - minint[k]);
        if (bitsize == 0) {
            for (int k = 0; k < 3; k++) w.write(bitsizeint[k], tmpc[k]);
        } else {
            w.write_ints(bitsize, sizeint, tmpc);
        }
        for (int k = 0; k < 3; k++) prev[k] = thiscoord[k];
        i++;
        thiscoord += 3;

        unsigned int runvals[24];
        int run = 0;
        if (!is_small && is_smaller == -1) is_smaller = 0;
        while (is_small && run < 8 * 3) {
            if (is_smaller == -1) {
                long d2 = 0;
                for (int k = 0; k < 3; k++) {
                    long d = (long)thiscoord[k] - prev[k];
                    d2 += d * d;
                }
                if (d2 >= (long)smaller * smaller) is_smaller = 0;
            }
            for (int k = 0; k < 3; k++)
                runvals[run++] = (unsigned int)(thiscoord[k] -
                                                prev[k] + smallnum);
            for (int k = 0; k < 3; k++) prev[k] = thiscoord[k];
            i++;
            thiscoord += 3;
            is_small =
                i < natoms &&
                std::abs((long)thiscoord[0] - prev[0]) < smallnum &&
                std::abs((long)thiscoord[1] - prev[1]) < smallnum &&
                std::abs((long)thiscoord[2] - prev[2]) < smallnum;
        }
        if (run != prevrun || is_smaller != 0) {
            prevrun = run;
            w.write(1, 1);
            w.write(5, (unsigned int)(run + is_smaller + 1));
        } else {
            w.write(1, 0);
        }
        for (int k3 = 0; k3 < run; k3 += 3)
            w.write_ints(smallidx, sizesmall, runvals + k3);
        if (is_smaller != 0) {
            smallidx += is_smaller;
            if (is_smaller < 0) {
                smallnum = smaller;
                smaller = MAGICINTS[smallidx - 1] / 2;
            } else {
                smaller = smallnum;
                smallnum = MAGICINTS[smallidx] / 2;
            }
            sizesmall[0] = sizesmall[1] = sizesmall[2] =
                (unsigned int)MAGICINTS[smallidx];
        }
        if (w.overflow) {
            delete[] ip;
            return -1;
        }
    }
    delete[] ip;
    long packed = w.flush();
    if (packed < 0 || w.overflow) return -1;
    write_be_i32(out + 32, (int)packed);
    long total = 36 + packed;
    long pad = (4 - (packed & 3)) & 3;
    if (total + pad > out_cap) return -1;
    for (long p = 0; p < pad; p++) out[total + p] = 0;
    return total + pad;
}

}  // extern "C"
