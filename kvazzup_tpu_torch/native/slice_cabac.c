/* Native CABAC slice-data codec — the production host-serial path.
 *
 * Mirrors kvazzup_tpu/entropy/{cabac,syntax,slice_data}.py bit-for-bit (the
 * Python modules remain the readable reference; tests assert byte equality).
 * This is the TPU build's counterpart of kvazaar's C entropy core
 * (Bitstream/CABAC groups, dependencies/kvazaar_CMakeLists.txt:207-218):
 * the one inherently bit-serial stage, kept on host while all pixel math
 * runs on device.
 *
 * Build: gcc -O2 -shared -fPIC slice_cabac.c -o libslice_cabac.so
 */

#include <stdint.h>
#include <string.h>
#include <stdlib.h>

#include "cabac_tables.h"

/* ------------------------------------------------------------ bit writer */

typedef struct {
    uint8_t *buf;
    long cap;
    long nbits; /* bits written so far */
    int error;
} BitBuf;

static void put_bit_raw(BitBuf *b, int bit) {
    long byte = b->nbits >> 3;
    if (byte >= b->cap) { b->error = 1; return; }
    if ((b->nbits & 7) == 0) b->buf[byte] = 0;
    b->buf[byte] |= (uint8_t)(bit << (7 - (b->nbits & 7)));
    b->nbits++;
}

/* ------------------------------------------------------------ encoder */

typedef struct {
    uint32_t low, range;
    int bits_outstanding;
    int first_bit;
    uint8_t state[NUM_CONTEXTS];
    uint8_t mps[NUM_CONTEXTS];
    BitBuf out;
} CabacEnc;

static void ctx_init(uint8_t *state, uint8_t *mps, int init_type, int slice_qp) {
    const uint8_t *iv = init_type == 0 ? INIT_VALUES_0 : (init_type == 1 ? INIT_VALUES_1 : INIT_VALUES_2);
    int qp = slice_qp < 0 ? 0 : (slice_qp > 51 ? 51 : slice_qp);
    for (int i = 0; i < NUM_CONTEXTS; i++) {
        int slope = (iv[i] >> 4) * 5 - 45;
        int offset = ((iv[i] & 15) << 3) - 16;
        int pre = ((slope * qp) >> 4) + offset;
        if (pre < 1) pre = 1;
        if (pre > 126) pre = 126;
        if (pre <= 63) { state[i] = (uint8_t)(63 - pre); mps[i] = 0; }
        else { state[i] = (uint8_t)(pre - 64); mps[i] = 1; }
    }
}

static void enc_init(CabacEnc *e, int init_type, int slice_qp, uint8_t *buf, long cap) {
    e->low = 0; e->range = 510; e->bits_outstanding = 0; e->first_bit = 1;
    e->out.buf = buf; e->out.cap = cap; e->out.nbits = 0; e->out.error = 0;
    ctx_init(e->state, e->mps, init_type, slice_qp);
}

static void enc_put_bit(CabacEnc *e, int bit) {
    if (e->first_bit) e->first_bit = 0; else put_bit_raw(&e->out, bit);
    while (e->bits_outstanding > 0) { put_bit_raw(&e->out, 1 - bit); e->bits_outstanding--; }
}

static void enc_renorm(CabacEnc *e) {
    while (e->range < 256) {
        if (e->low >= 512) { enc_put_bit(e, 1); e->low -= 512; }
        else if (e->low < 256) enc_put_bit(e, 0);
        else { e->low -= 256; e->bits_outstanding++; }
        e->range <<= 1; e->low <<= 1;
    }
}

static void enc_bin(CabacEnc *e, int ctx, int bin) {
    int st = e->state[ctx], mps = e->mps[ctx];
    uint32_t lps = RANGE_TAB_LPS[st][(e->range >> 6) & 3];
    e->range -= lps;
    if (bin != mps) {
        e->low += e->range;
        e->range = lps;
        if (st == 0) e->mps[ctx] = (uint8_t)(1 - mps);
        e->state[ctx] = TRANS_IDX_LPS[st];
    } else {
        e->state[ctx] = TRANS_IDX_MPS[st];
    }
    enc_renorm(e);
}

static void enc_bypass(CabacEnc *e, int bin) {
    e->low <<= 1;
    if (bin) e->low += e->range;
    if (e->low >= 1024) { enc_put_bit(e, 1); e->low -= 1024; }
    else if (e->low < 512) enc_put_bit(e, 0);
    else { e->low -= 512; e->bits_outstanding++; }
}

static void enc_bypass_bits(CabacEnc *e, uint32_t v, int n) {
    for (int i = n - 1; i >= 0; i--) enc_bypass(e, (v >> i) & 1);
}

static void enc_flush(CabacEnc *e) {
    e->range = 2;
    enc_renorm(e);
    enc_put_bit(e, (e->low >> 9) & 1);
    put_bit_raw(&e->out, (e->low >> 8) & 1);
    put_bit_raw(&e->out, 1);
}

static void enc_terminate(CabacEnc *e, int bin) {
    e->range -= 2;
    if (bin) { e->low += e->range; enc_flush(e); }
    else enc_renorm(e);
}

/* ------------------------------------------------------------ decoder */

typedef struct {
    uint32_t range, offset;
    const uint8_t *buf;
    long nbits, bitpos;
    uint8_t state[NUM_CONTEXTS];
    uint8_t mps[NUM_CONTEXTS];
} CabacDec;

static int dec_read_bit(CabacDec *d) {
    if (d->bitpos >= d->nbits) return 0;
    int b = (d->buf[d->bitpos >> 3] >> (7 - (d->bitpos & 7))) & 1;
    d->bitpos++;
    return b;
}

static void dec_init(CabacDec *d, const uint8_t *buf, long len, int init_type, int slice_qp) {
    d->buf = buf; d->nbits = len * 8; d->bitpos = 0;
    d->range = 510; d->offset = 0;
    for (int i = 0; i < 9; i++) d->offset = (d->offset << 1) | dec_read_bit(d);
    ctx_init(d->state, d->mps, init_type, slice_qp);
}

static int dec_bin(CabacDec *d, int ctx) {
    int st = d->state[ctx], mps = d->mps[ctx];
    uint32_t lps = RANGE_TAB_LPS[st][(d->range >> 6) & 3];
    int bin;
    d->range -= lps;
    if (d->offset >= d->range) {
        bin = 1 - mps;
        d->offset -= d->range;
        d->range = lps;
        if (st == 0) d->mps[ctx] = (uint8_t)(1 - mps);
        d->state[ctx] = TRANS_IDX_LPS[st];
    } else {
        bin = mps;
        d->state[ctx] = TRANS_IDX_MPS[st];
    }
    while (d->range < 256) { d->range <<= 1; d->offset = (d->offset << 1) | dec_read_bit(d); }
    return bin;
}

static int dec_bypass(CabacDec *d) {
    d->offset = (d->offset << 1) | dec_read_bit(d);
    if (d->offset >= d->range) { d->offset -= d->range; return 1; }
    return 0;
}

static uint32_t dec_bypass_bits(CabacDec *d, int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | dec_bypass(d);
    return v;
}

static int dec_terminate(CabacDec *d) {
    d->range -= 2;
    if (d->offset >= d->range) return 1;
    while (d->range < 256) { d->range <<= 1; d->offset = (d->offset << 1) | dec_read_bit(d); }
    return 0;
}

/* ------------------------------------------------------- coeff remaining */

static void enc_remaining(CabacEnc *e, uint32_t value, int rice) {
    uint32_t q = value >> rice;
    if (q < 4) {
        enc_bypass_bits(e, (1u << (q + 1)) - 2, q + 1);
        if (rice) enc_bypass_bits(e, value & ((1u << rice) - 1), rice);
    } else {
        uint32_t v = value - (4u << rice);
        int c = 0;
        while (v >= (1u << (rice + 1 + c))) { v -= 1u << (rice + 1 + c); c++; }
        int ones = 4 + c;
        enc_bypass_bits(e, ((1u << ones) - 1) << 1, ones + 1);
        enc_bypass_bits(e, v, rice + 1 + c);
    }
}

static uint32_t dec_remaining(CabacDec *d, int rice) {
    int prefix = 0;
    while (prefix < 32 && dec_bypass(d)) prefix++;
    if (prefix < 4) return ((uint32_t)prefix << rice) + (rice ? dec_bypass_bits(d, rice) : 0);
    int c = prefix - 4;
    uint32_t base = (4u << rice) + (((1u << c) - 1) << (rice + 1));
    return base + dec_bypass_bits(d, rice + 1 + c);
}

/* ------------------------------------------------------------ scans */

/* diag scan of size s (up-right): fills pos[i] = y*s + x */
static void diag_scan(int s, int *pos) {
    int i = 0, x = 0, y = 0;
    while (i < s * s) {
        while (y >= 0) {
            if (x < s && y < s) pos[i++] = y * s + x;
            y--; x++;
        }
        y = x; x = 0;
    }
}

static void horiz_scan(int s, int *pos) {
    int i = 0;
    for (int y = 0; y < s; y++) for (int x = 0; x < s; x++) pos[i++] = y * s + x;
}

static void vert_scan(int s, int *pos) {
    int i = 0;
    for (int x = 0; x < s; x++) for (int y = 0; y < s; y++) pos[i++] = y * s + x;
}

static void get_scan(int scan_idx, int s, int *pos) {
    if (scan_idx == 1) horiz_scan(s, pos);
    else if (scan_idx == 2) vert_scan(s, pos);
    else diag_scan(s, pos);
}

static const int CTX_IDX_MAP_4X4[16] = {0,1,4,5,2,3,4,5,6,6,8,8,7,7,8,8};

static int last_prefix_ctx(int log2, int c_idx, int bin_idx) {
    int offset, shift;
    if (c_idx == 0) { offset = 3 * (log2 - 2) + ((log2 - 1) >> 2); shift = (log2 + 1) >> 2; }
    else { offset = 15; shift = log2 - 2; }
    return (bin_idx >> shift) + offset;
}

static int sig_ctx(int log2, int c_idx, int scan_idx, int xc, int yc, const uint8_t *csbf, int nsb) {
    int sig;
    if (log2 == 2) sig = CTX_IDX_MAP_4X4[(yc << 2) + xc];
    else if (xc + yc == 0) sig = 0;
    else {
        int xs = xc >> 2, ys = yc >> 2;
        int prev = 0;
        if (xs < nsb - 1) prev += csbf[ys * nsb + xs + 1];
        if (ys < nsb - 1) prev += 2 * csbf[(ys + 1) * nsb + xs];
        int xp = xc & 3, yp = yc & 3;
        if (prev == 0) sig = (xp + yp == 0) ? 2 : (xp + yp < 3 ? 1 : 0);
        else if (prev == 1) sig = (yp == 0) ? 2 : (yp == 1 ? 1 : 0);
        else if (prev == 2) sig = (xp == 0) ? 2 : (xp == 1 ? 1 : 0);
        else sig = 2;
        if (c_idx == 0) {
            if (xs + ys > 0) sig += 3;
            sig += (log2 == 3) ? (scan_idx == 0 ? 9 : 15) : 21;
        } else {
            sig += (log2 == 3) ? 9 : 12;
        }
    }
    return CTX_SIG_COEFF_FLAG + sig + (c_idx ? 27 : 0);
}

static int last_prefix_of(int v) {
    if (v < 4) return v;
    int p = 4;
    for (;;) {
        int nbits = (p >> 1) - 1;
        int base = (2 + (p & 1)) << nbits;
        if (v < base + (1 << nbits)) return p;
        p++;
    }
}

/* -------------------------------------------------- residual encode */

static int encode_residual(CabacEnc *e, const int32_t *coeffs, int log2, int c_idx, int scan_idx) {
    int n = 1 << log2;
    int pos4[16];
    int sbpos[64];
    int nsb_dim = n >> 2; if (nsb_dim < 1) nsb_dim = 1;
    int nsb = nsb_dim * nsb_dim;
    get_scan(scan_idx, 4, pos4);
    get_scan(scan_idx, nsb_dim, sbpos);

    /* last significant position in scan order */
    int last_pos = -1;
    for (int i = 0; i < nsb; i++) {
        int sb = sbpos[i];
        int sx = sb % nsb_dim, sy = sb / nsb_dim;
        for (int k = 0; k < 16; k++) {
            int px = pos4[k] % 4, py = pos4[k] / 4;
            if (coeffs[((sy << 2) + py) * n + (sx << 2) + px]) last_pos = i * 16 + k;
        }
    }
    if (last_pos < 0) return -1;
    int last_sb = last_pos >> 4, last_scan = last_pos & 15;
    int lsb = sbpos[last_sb];
    int lsx = lsb % nsb_dim, lsy = lsb / nsb_dim;
    int lpx = pos4[last_scan] % 4, lpy = pos4[last_scan] / 4;
    int last_x = (lsx << 2) + lpx, last_y = (lsy << 2) + lpy;
    if (scan_idx == 2) { int t = last_x; last_x = last_y; last_y = t; }

    /* last_sig_coeff_x/y prefix+suffix */
    int cmax = (log2 << 1) - 1;
    int pref_x = last_prefix_of(last_x), pref_y = last_prefix_of(last_y);
    for (int b = 0; b < pref_x; b++) enc_bin(e, CTX_LAST_SIG_COEFF_X_PREFIX + last_prefix_ctx(log2, c_idx, b), 1);
    if (pref_x < cmax) enc_bin(e, CTX_LAST_SIG_COEFF_X_PREFIX + last_prefix_ctx(log2, c_idx, pref_x), 0);
    for (int b = 0; b < pref_y; b++) enc_bin(e, CTX_LAST_SIG_COEFF_Y_PREFIX + last_prefix_ctx(log2, c_idx, b), 1);
    if (pref_y < cmax) enc_bin(e, CTX_LAST_SIG_COEFF_Y_PREFIX + last_prefix_ctx(log2, c_idx, pref_y), 0);
    if (pref_x > 3) { int nb = (pref_x >> 1) - 1; enc_bypass_bits(e, last_x - ((2 + (pref_x & 1)) << nb), nb); }
    if (pref_y > 3) { int nb = (pref_y >> 1) - 1; enc_bypass_bits(e, last_y - ((2 + (pref_y & 1)) << nb), nb); }

    uint8_t csbf[64];
    memset(csbf, 0, sizeof csbf);
    for (int i = 0; i < nsb; i++) {
        int sb = sbpos[i];
        int sx = sb % nsb_dim, sy = sb / nsb_dim;
        int any = 0;
        for (int py = 0; py < 4; py++)
            for (int px = 0; px < 4; px++)
                if (coeffs[((sy << 2) + py) * n + (sx << 2) + px]) any = 1;
        csbf[sy * nsb_dim + sx] = (uint8_t)any;
    }
    csbf[lsy * nsb_dim + lsx] = 1;

    int prev_c1 = 1;
    for (int i = last_sb; i >= 0; i--) {
        int sb = sbpos[i];
        int sx = sb % nsb_dim, sy = sb / nsb_dim;
        int infer_dc = 0;
        int coded = csbf[sy * nsb_dim + sx];
        if (i > 0 && i < last_sb) {
            int ctx = 0;
            if (sx < nsb_dim - 1) ctx += csbf[sy * nsb_dim + sx + 1];
            if (sy < nsb_dim - 1) ctx += csbf[(sy + 1) * nsb_dim + sx];
            enc_bin(e, CTX_CODED_SUB_BLOCK_FLAG + (ctx > 1 ? 1 : ctx) + (c_idx ? 2 : 0), coded);
            infer_dc = 1;
        } else {
            coded = 1;
            csbf[sy * nsb_dim + sx] = 1;
        }
        if (!coded) continue;

        int sig[16];
        int32_t levels[16];
        for (int k = 0; k < 16; k++) {
            int px = pos4[k] % 4, py = pos4[k] / 4;
            levels[k] = coeffs[((sy << 2) + py) * n + (sx << 2) + px];
            sig[k] = levels[k] != 0;
        }
        int start = (i == last_sb) ? last_scan - 1 : 15;
        if (i == last_sb) sig[last_scan] = 1;
        for (int k = start; k >= 0; k--) {
            if (k > 0 || !infer_dc) {
                int px = pos4[k] % 4, py = pos4[k] / 4;
                enc_bin(e, sig_ctx(log2, c_idx, scan_idx, (sx << 2) + px, (sy << 2) + py, csbf, nsb_dim), sig[k]);
                if (sig[k]) infer_dc = 0;
            }
            /* else: DC significance inferred to 1 by the decoder */
        }

        /* levels */
        int sig_pos[16], nsig = 0;
        int kmax = (i == last_sb) ? last_scan : 15;
        for (int k = kmax; k >= 0; k--) if (sig[k]) sig_pos[nsig++] = k;
        if (!nsig) continue;
        int ctx_set = ((i > 0 && c_idx == 0) ? 2 : 0) + (prev_c1 == 0 ? 1 : 0);
        int c1 = 1;
        int g1_base = CTX_COEFF_ABS_LEVEL_GREATER1_FLAG + (c_idx ? 16 : 0);
        int g2_base = CTX_COEFF_ABS_LEVEL_GREATER2_FLAG + (c_idx ? 4 : 0);
        int num_g1 = nsig < 8 ? nsig : 8;
        int g1_flag[16], has_g1[16], g2_val = 0, first_g1 = -1;
        memset(has_g1, 0, sizeof has_g1);
        for (int idx = 0; idx < num_g1; idx++) {
            int k = sig_pos[idx];
            int32_t a = levels[k] < 0 ? -levels[k] : levels[k];
            int flag = a > 1;
            enc_bin(e, g1_base + ctx_set * 4 + c1, flag);
            g1_flag[k] = flag; has_g1[k] = 1;
            if (flag) { if (first_g1 < 0) first_g1 = k; c1 = 0; }
            else if (c1 > 0 && c1 < 3) c1++;
        }
        int has_g2 = 0;
        if (first_g1 >= 0) {
            int32_t a = levels[first_g1] < 0 ? -levels[first_g1] : levels[first_g1];
            g2_val = a > 2;
            enc_bin(e, g2_base + ctx_set, g2_val);
            has_g2 = 1;
        }
        for (int idx = 0; idx < nsig; idx++) enc_bypass(e, levels[sig_pos[idx]] < 0);
        int rice = 0;
        for (int idx = 0; idx < nsig; idx++) {
            int k = sig_pos[idx];
            int32_t a = levels[k] < 0 ? -levels[k] : levels[k];
            int g1 = has_g1[k] ? g1_flag[k] : 0;
            int g2 = (has_g2 && k == first_g1) ? g2_val : 0;
            int base_level = 1 + g1 + g2;
            int saturated = (idx >= 8) || (has_g1[k] && g1 == 1 && !(has_g2 && k == first_g1)) || g2 == 1;
            if (saturated) {
                enc_remaining(e, (uint32_t)(a - base_level), rice);
                if (a > (3 << rice) && rice < 4) rice++;
            }
        }
        prev_c1 = c1;
    }
    return 0;
}

/* -------------------------------------------------- residual decode */

static int decode_residual(CabacDec *d, int32_t *coeffs, int log2, int c_idx, int scan_idx) {
    int n = 1 << log2;
    int pos4[16];
    int sbpos[64];
    int nsb_dim = n >> 2; if (nsb_dim < 1) nsb_dim = 1;
    int nsb = nsb_dim * nsb_dim;
    get_scan(scan_idx, 4, pos4);
    get_scan(scan_idx, nsb_dim, sbpos);
    memset(coeffs, 0, sizeof(int32_t) * n * n);

    int cmax = (log2 << 1) - 1;
    int pref_x = 0, pref_y = 0;
    while (pref_x < cmax && dec_bin(d, CTX_LAST_SIG_COEFF_X_PREFIX + last_prefix_ctx(log2, c_idx, pref_x))) pref_x++;
    while (pref_y < cmax && dec_bin(d, CTX_LAST_SIG_COEFF_Y_PREFIX + last_prefix_ctx(log2, c_idx, pref_y))) pref_y++;
    int last_x, last_y;
    if (pref_x > 3) { int nb = (pref_x >> 1) - 1; last_x = ((2 + (pref_x & 1)) << nb) + dec_bypass_bits(d, nb); }
    else last_x = pref_x;
    if (pref_y > 3) { int nb = (pref_y >> 1) - 1; last_y = ((2 + (pref_y & 1)) << nb) + dec_bypass_bits(d, nb); }
    else last_y = pref_y;
    if (scan_idx == 2) { int t = last_x; last_x = last_y; last_y = t; }

    int last_pos = -1;
    for (int i = 0; i < nsb && last_pos < 0; i++) {
        int sb = sbpos[i];
        int sx = sb % nsb_dim, sy = sb / nsb_dim;
        for (int k = 0; k < 16; k++) {
            int px = pos4[k] % 4, py = pos4[k] / 4;
            if ((sx << 2) + px == last_x && (sy << 2) + py == last_y) { last_pos = i * 16 + k; break; }
        }
    }
    if (last_pos < 0) return -1;
    int last_sb = last_pos >> 4, last_scan = last_pos & 15;

    uint8_t csbf[64];
    memset(csbf, 0, sizeof csbf);
    int prev_c1 = 1;
    for (int i = last_sb; i >= 0; i--) {
        int sb = sbpos[i];
        int sx = sb % nsb_dim, sy = sb / nsb_dim;
        int infer_dc = 0, coded;
        if (i > 0 && i < last_sb) {
            int ctx = 0;
            if (sx < nsb_dim - 1) ctx += csbf[sy * nsb_dim + sx + 1];
            if (sy < nsb_dim - 1) ctx += csbf[(sy + 1) * nsb_dim + sx];
            coded = dec_bin(d, CTX_CODED_SUB_BLOCK_FLAG + (ctx > 1 ? 1 : ctx) + (c_idx ? 2 : 0));
            infer_dc = 1;
        } else coded = 1;
        csbf[sy * nsb_dim + sx] = (uint8_t)coded;
        if (!coded) continue;

        int sig[16];
        memset(sig, 0, sizeof sig);
        int start = (i == last_sb) ? last_scan - 1 : 15;
        if (i == last_sb) sig[last_scan] = 1;
        for (int k = start; k >= 0; k--) {
            if (k > 0 || !infer_dc) {
                int px = pos4[k] % 4, py = pos4[k] / 4;
                sig[k] = dec_bin(d, sig_ctx(log2, c_idx, scan_idx, (sx << 2) + px, (sy << 2) + py, csbf, nsb_dim));
                if (sig[k]) infer_dc = 0;
            } else sig[0] = 1;
        }

        int sig_pos[16], nsig = 0;
        int kmax = (i == last_sb) ? last_scan : 15;
        for (int k = kmax; k >= 0; k--) if (sig[k]) sig_pos[nsig++] = k;
        if (!nsig) continue;
        int ctx_set = ((i > 0 && c_idx == 0) ? 2 : 0) + (prev_c1 == 0 ? 1 : 0);
        int c1 = 1;
        int g1_base = CTX_COEFF_ABS_LEVEL_GREATER1_FLAG + (c_idx ? 16 : 0);
        int g2_base = CTX_COEFF_ABS_LEVEL_GREATER2_FLAG + (c_idx ? 4 : 0);
        int num_g1 = nsig < 8 ? nsig : 8;
        int g1_flag[16], has_g1[16], g2_val = 0, has_g2 = 0, first_g1 = -1;
        memset(has_g1, 0, sizeof has_g1);
        for (int idx = 0; idx < num_g1; idx++) {
            int k = sig_pos[idx];
            int flag = dec_bin(d, g1_base + ctx_set * 4 + c1);
            g1_flag[k] = flag; has_g1[k] = 1;
            if (flag) { if (first_g1 < 0) first_g1 = k; c1 = 0; }
            else if (c1 > 0 && c1 < 3) c1++;
        }
        if (first_g1 >= 0) { g2_val = dec_bin(d, g2_base + ctx_set); has_g2 = 1; }
        int sign[16];
        for (int idx = 0; idx < nsig; idx++) sign[idx] = dec_bypass(d);
        int rice = 0;
        for (int idx = 0; idx < nsig; idx++) {
            int k = sig_pos[idx];
            int g1 = has_g1[k] ? g1_flag[k] : 0;
            int g2 = (has_g2 && k == first_g1) ? g2_val : 0;
            int base_level = 1 + g1 + g2;
            int saturated = (idx >= 8) || (has_g1[k] && g1 == 1 && !(has_g2 && k == first_g1)) || g2 == 1;
            int32_t a = base_level;
            if (saturated) {
                a = base_level + (int32_t)dec_remaining(d, rice);
                if (a > (3 << rice) && rice < 4) rice++;
            }
            int px = pos4[k] % 4, py = pos4[k] / 4;
            coeffs[((sy << 2) + py) * n + (sx << 2) + px] = sign[idx] ? -a : a;
        }
        prev_c1 = c1;
    }
    return 0;
}

/* -------------------------------------------------- CU-layer (intra v1) */

static void mpm_list(int a, int b, int mpm[3]) {
    if (a == b) {
        if (a < 2) { mpm[0] = 0; mpm[1] = 1; mpm[2] = 26; }
        else { mpm[0] = a; mpm[1] = 2 + ((a + 29) % 32); mpm[2] = 2 + ((a - 1) % 32); }
    } else {
        mpm[0] = a; mpm[1] = b;
        mpm[2] = (a != 0 && b != 0) ? 0 : ((a != 1 && b != 1) ? 1 : 26);
    }
}

static void enc_luma_mode(CabacEnc *e, int mode, int a, int b) {
    int mpm[3];
    mpm_list(a, b, mpm);
    int idx = -1;
    for (int i = 0; i < 3; i++) if (mpm[i] == mode) { idx = i; break; }
    if (idx >= 0) {
        enc_bin(e, CTX_PREV_INTRA_LUMA_PRED_FLAG, 1);
        enc_bypass(e, idx ? 1 : 0);
        if (idx) enc_bypass(e, idx - 1);
    } else {
        enc_bin(e, CTX_PREV_INTRA_LUMA_PRED_FLAG, 0);
        int s[3] = {mpm[0], mpm[1], mpm[2]};
        /* sort descending */
        for (int i = 0; i < 2; i++) for (int j = i + 1; j < 3; j++) if (s[j] > s[i]) { int t = s[i]; s[i] = s[j]; s[j] = t; }
        int rem = mode;
        for (int i = 0; i < 3; i++) if (mode > s[i]) rem--;
        enc_bypass_bits(e, (uint32_t)rem, 5);
    }
}

static int dec_luma_mode(CabacDec *d, int a, int b) {
    int mpm[3];
    mpm_list(a, b, mpm);
    if (dec_bin(d, CTX_PREV_INTRA_LUMA_PRED_FLAG)) {
        int idx = 0;
        if (dec_bypass(d)) idx = 1 + dec_bypass(d);
        return mpm[idx];
    }
    int rem = (int)dec_bypass_bits(d, 5);
    int s[3] = {mpm[0], mpm[1], mpm[2]};
    for (int i = 0; i < 2; i++) for (int j = i + 1; j < 3; j++) if (s[j] < s[i]) { int t = s[i]; s[i] = s[j]; s[j] = t; }
    for (int i = 0; i < 3; i++) if (rem >= s[i]) rem++;
    return rem;
}

static int any_nonzero(const int32_t *p, int count) {
    for (int i = 0; i < count; i++) if (p[i]) return 1;
    return 0;
}

long encode_slice_data_intra_c(
    const int32_t *modes, const int32_t *lev_y, const int32_t *lev_cb, const int32_t *lev_cr,
    int nctu, int ctbs_w, int ctb_log2, int at_min_cb, int slice_qp,
    uint8_t *out, long out_cap) {
    CabacEnc e;
    enc_init(&e, 0, slice_qp, out, out_cap);
    int n = 1 << ctb_log2;
    int ylen = n * n, clen = (n / 2) * (n / 2);
    for (int i = 0; i < nctu; i++) {
        int c = i % ctbs_w;
        int mode = modes[i];
        if (at_min_cb) enc_bin(&e, CTX_PART_MODE, 1);
        int cand_a = c > 0 ? modes[i - 1] : 1;
        enc_luma_mode(&e, mode, cand_a, 1);
        enc_bin(&e, CTX_INTRA_CHROMA_PRED_MODE, 0);
        const int32_t *ly = lev_y + (long)i * ylen;
        const int32_t *lcb = lev_cb + (long)i * clen;
        const int32_t *lcr = lev_cr + (long)i * clen;
        int cbf_cb = any_nonzero(lcb, clen);
        int cbf_cr = any_nonzero(lcr, clen);
        int cbf_y = any_nonzero(ly, ylen);
        enc_bin(&e, CTX_CBF_CHROMA, cbf_cb);
        enc_bin(&e, CTX_CBF_CHROMA, cbf_cr);
        enc_bin(&e, CTX_CBF_LUMA + 1, cbf_y);
        if (cbf_y && encode_residual(&e, ly, ctb_log2, 0, 0)) return -2;
        if (cbf_cb && encode_residual(&e, lcb, ctb_log2 - 1, 1, 0)) return -2;
        if (cbf_cr && encode_residual(&e, lcr, ctb_log2 - 1, 2, 0)) return -2;
        enc_terminate(&e, i == nctu - 1);
        if (e.out.error) return -1;
    }
    /* byte-align with zeros */
    while (e.out.nbits & 7) put_bit_raw(&e.out, 0);
    return e.out.nbits >> 3;
}

int decode_slice_data_intra_c(
    const uint8_t *payload, long payload_len,
    int nctu, int ctbs_w, int ctb_log2, int at_min_cb, int slice_qp,
    int32_t *modes, int32_t *lev_y, int32_t *lev_cb, int32_t *lev_cr) {
    CabacDec d;
    dec_init(&d, payload, payload_len, 0, slice_qp);
    int n = 1 << ctb_log2;
    int ylen = n * n, clen = (n / 2) * (n / 2);
    memset(lev_y, 0, sizeof(int32_t) * (long)nctu * ylen);
    memset(lev_cb, 0, sizeof(int32_t) * (long)nctu * clen);
    memset(lev_cr, 0, sizeof(int32_t) * (long)nctu * clen);
    for (int i = 0; i < nctu; i++) {
        int c = i % ctbs_w;
        if (at_min_cb) {
            if (dec_bin(&d, CTX_PART_MODE) != 1) return -10; /* NxN unsupported */
        }
        int cand_a = c > 0 ? modes[i - 1] : 1;
        modes[i] = dec_luma_mode(&d, cand_a, 1);
        if (dec_bin(&d, CTX_INTRA_CHROMA_PRED_MODE) != 0) return -11;
        int cbf_cb = dec_bin(&d, CTX_CBF_CHROMA);
        int cbf_cr = dec_bin(&d, CTX_CBF_CHROMA);
        int cbf_y = dec_bin(&d, CTX_CBF_LUMA + 1);
        if (cbf_y && decode_residual(&d, lev_y + (long)i * ylen, ctb_log2, 0, 0)) return -12;
        if (cbf_cb && decode_residual(&d, lev_cb + (long)i * clen, ctb_log2 - 1, 1, 0)) return -12;
        if (cbf_cr && decode_residual(&d, lev_cr + (long)i * clen, ctb_log2 - 1, 2, 0)) return -12;
        int end = dec_terminate(&d);
        int expected = (i == nctu - 1) ? 1 : 0;
        if (end != expected) return -13;
    }
    return 0;
}

/* ==================================================================== */
/* P-slice CU syntax + WPP substreams (entropy_coding_sync)             */
/* Mirrors entropy/slice_data.py byte-for-byte.                         */

#include <pthread.h>

enum { CT_INTRA = 0, CT_MERGE = 1, CT_AMVP = 2, CT_SKIP = 3 };

static void enc_egk(CabacEnc *e, uint32_t v, int k) {
    while (v >= (1u << k)) { enc_bypass(e, 1); v -= 1u << k; k++; }
    enc_bypass(e, 0);
    enc_bypass_bits(e, v, k);
}

static uint32_t dec_egk(CabacDec *d, int k) {
    uint32_t v = 0;
    while (dec_bypass(d)) { v += 1u << k; k++; }
    return v + dec_bypass_bits(d, k);
}

static void enc_mvd(CabacEnc *e, int mvd_x, int mvd_y) {
    int ax = mvd_x < 0 ? -mvd_x : mvd_x;
    int ay = mvd_y < 0 ? -mvd_y : mvd_y;
    enc_bin(e, CTX_ABS_MVD_GREATER_FLAG, ax > 0);
    enc_bin(e, CTX_ABS_MVD_GREATER_FLAG, ay > 0);
    if (ax > 0) enc_bin(e, CTX_ABS_MVD_GREATER_FLAG + 1, ax > 1);
    if (ay > 0) enc_bin(e, CTX_ABS_MVD_GREATER_FLAG + 1, ay > 1);
    if (ax > 0) {
        if (ax > 1) enc_egk(e, (uint32_t)(ax - 2), 1);
        enc_bypass(e, mvd_x < 0);
    }
    if (ay > 0) {
        if (ay > 1) enc_egk(e, (uint32_t)(ay - 2), 1);
        enc_bypass(e, mvd_y < 0);
    }
}

static void dec_mvd(CabacDec *d, int *mvd_x, int *mvd_y) {
    int g0x = dec_bin(d, CTX_ABS_MVD_GREATER_FLAG);
    int g0y = dec_bin(d, CTX_ABS_MVD_GREATER_FLAG);
    int g1x = g0x ? dec_bin(d, CTX_ABS_MVD_GREATER_FLAG + 1) : 0;
    int g1y = g0y ? dec_bin(d, CTX_ABS_MVD_GREATER_FLAG + 1) : 0;
    int out[2] = {0, 0};
    int g0[2] = {g0x, g0y}, g1[2] = {g1x, g1y};
    for (int i = 0; i < 2; i++) {
        if (g0[i]) {
            int a = 1;
            if (g1[i]) a = 2 + (int)dec_egk(d, 1);
            if (dec_bypass(d)) a = -a;
            out[i] = a;
        }
    }
    *mvd_x = out[0];
    *mvd_y = out[1];
}

/* merge first candidate: A1(left), B1(above), B0(above-right), B2(above-left) */
static void merge_first_mv(int i, int cw, const uint8_t *inter, const int32_t *mvs, int32_t mv[2]) {
    int c = i % cw, r = i / cw;
    int order[4]; int norder = 0;
    if (c > 0) order[norder++] = i - 1;
    if (r > 0) order[norder++] = i - cw;
    if (r > 0 && c + 1 < cw) order[norder++] = i - cw + 1;
    if (r > 0 && c > 0) order[norder++] = i - cw - 1;
    for (int k = 0; k < norder; k++) {
        int j = order[k];
        if (inter[j]) { mv[0] = mvs[2 * j]; mv[1] = mvs[2 * j + 1]; return; }
    }
    mv[0] = mv[1] = 0;
}

/* spec merge list on the one-CU-per-CTB grid (8.5.3.2.3): A1, B1(!=A1),
 * B0(!=B1), B2 (if <4 so far, !=A1,!=B1), temporal (8.5.3.2.8: the
 * bottom-right col PU is always in the next CTB row -> unavailable, so
 * the center = the col picture's same-CTU MV; identity scaling in the
 * single-ref low-delay chain), zero-fill; A0 never decoded. */
static void merge_list_c(int i, int cw, const uint8_t *inter, const int32_t *mvs,
                         int merge_k, int col_ok, int32_t col_x, int32_t col_y,
                         int32_t out[][2]) {
    int c = i % cw, r = i / cw;
    int32_t cand[4][2];
    int have[4] = {0, 0, 0, 0};
    int js[4] = {i - 1, i - cw, i - cw + 1, i - cw - 1};
    int oks[4] = {c > 0, r > 0, r > 0 && c + 1 < cw, r > 0 && c > 0};
    for (int k = 0; k < 4; k++)
        if (oks[k] && inter[js[k]]) {
            have[k] = 1;
            cand[k][0] = mvs[2 * js[k]];
            cand[k][1] = mvs[2 * js[k] + 1];
        }
    int n = 0;
#define MEQ(a, b) (have[a] && have[b] && cand[a][0] == cand[b][0] && cand[a][1] == cand[b][1])
    if (have[0]) { out[n][0] = cand[0][0]; out[n][1] = cand[0][1]; n++; }
    if (have[1] && !MEQ(1, 0)) { out[n][0] = cand[1][0]; out[n][1] = cand[1][1]; n++; }
    if (have[2] && !MEQ(2, 1)) { out[n][0] = cand[2][0]; out[n][1] = cand[2][1]; n++; }
    if (n < 4 && have[3] && !MEQ(3, 0) && !MEQ(3, 1)) {
        out[n][0] = cand[3][0]; out[n][1] = cand[3][1]; n++;
    }
#undef MEQ
    if (col_ok && n < merge_k) {  /* temporal: appended, never pruned */
        out[n][0] = col_x; out[n][1] = col_y; n++;
    }
    while (n < merge_k) { out[n][0] = 0; out[n][1] = 0; n++; }
}

/* merge_idx: TR with cMax = k-1, first bin ctx-coded, rest bypass (9.3.3.9) */
static void enc_merge_idx(CabacEnc *e, int idx, int k) {
    if (k <= 1) return;
    enc_bin(e, CTX_MERGE_IDX, idx > 0);
    if (idx > 0) {
        for (int j = 1; j < idx; j++) enc_bypass(e, 1);
        if (idx < k - 1) enc_bypass(e, 0);
    }
}

static int dec_merge_idx(CabacDec *d, int k) {
    if (k <= 1) return 0;
    if (!dec_bin(d, CTX_MERGE_IDX)) return 0;
    int idx = 1;
    while (idx < k - 1 && dec_bypass(d)) idx++;
    return idx;
}

static void amvp_cands(int i, int cw, const uint8_t *inter, const int32_t *mvs,
                       int col_ok, int32_t col_x, int32_t col_y,
                       int32_t mvp0[2], int32_t mvp1[2]) {
    int c = i % cw, r = i / cw;
    int a_ok = (c > 0) && inter[i - 1];
    int32_t a_mv[2] = {0, 0};
    if (a_ok) { a_mv[0] = mvs[2 * (i - 1)]; a_mv[1] = mvs[2 * (i - 1) + 1]; }
    int b_ok = 0;
    int32_t b_mv[2] = {0, 0};
    int order[3]; int norder = 0;
    if (r > 0 && c + 1 < cw) order[norder++] = i - cw + 1;
    if (r > 0) order[norder++] = i - cw;
    if (r > 0 && c > 0) order[norder++] = i - cw - 1;
    for (int k = 0; k < norder && !b_ok; k++) {
        int j = order[k];
        if (inter[j]) { b_ok = 1; b_mv[0] = mvs[2 * j]; b_mv[1] = mvs[2 * j + 1]; }
    }
    int both = a_ok && b_ok;
    int same = both && a_mv[0] == b_mv[0] && a_mv[1] == b_mv[1];
    /* 8.5.3.2.6: spatial A, spatial B (pruned vs A), then temporal when
     * fewer than two entries, then zero fill */
    int nspat = (a_ok ? 1 : 0) + ((b_ok && !(a_ok && same)) ? 1 : 0);
    if (a_ok) { mvp0[0] = a_mv[0]; mvp0[1] = a_mv[1]; }
    else if (b_ok) { mvp0[0] = b_mv[0]; mvp0[1] = b_mv[1]; }
    else if (col_ok) { mvp0[0] = col_x; mvp0[1] = col_y; }
    else mvp0[0] = mvp0[1] = 0;
    if (nspat == 2) { mvp1[0] = b_mv[0]; mvp1[1] = b_mv[1]; }
    else if (nspat == 1 && col_ok) { mvp1[0] = col_x; mvp1[1] = col_y; }
    else mvp1[0] = mvp1[1] = 0;
}

/* per-slice array bundle */
typedef struct {
    const int32_t *ctype;      /* NULL for I slices */
    const int32_t *intra_modes;
    const int32_t *mvs;        /* (nctu,2) */
    const int32_t *mvp_flags;
    const int32_t *mvds;       /* (nctu,2) */
    const int32_t *lev_y, *lev_cb, *lev_cr;
    uint8_t *skip;             /* (nctu,) scratch, encoder precomputed */
    int ctbs_w, ctbs_h, ctb_log2, at_min_cb;
    const int32_t *merge_idxs; /* NULL -> all 0 */
    int merge_k;               /* MaxNumMergeCand (slice header) */
    const int32_t *col_mv;     /* (nctu,2) collocated motion; NULL = no TMVP */
    const uint8_t *col_inter;  /* (nctu,) collocated inter flags */
} SliceArrays;

static void enc_ctu_i(CabacEnc *e, const SliceArrays *sa, int i) {
    int cw = sa->ctbs_w;
    int c = i % cw;
    int n = 1 << sa->ctb_log2;
    int ylen = n * n, clen = (n / 2) * (n / 2);
    if (sa->at_min_cb) enc_bin(e, CTX_PART_MODE, 1);
    int cand_a = c > 0 ? sa->intra_modes[i - 1] : 1;
    enc_luma_mode(e, sa->intra_modes[i], cand_a, 1);
    enc_bin(e, CTX_INTRA_CHROMA_PRED_MODE, 0);
    const int32_t *ly = sa->lev_y + (long)i * ylen;
    const int32_t *lcb = sa->lev_cb + (long)i * clen;
    const int32_t *lcr = sa->lev_cr + (long)i * clen;
    int cbf_cb = any_nonzero(lcb, clen), cbf_cr = any_nonzero(lcr, clen), cbf_y = any_nonzero(ly, ylen);
    enc_bin(e, CTX_CBF_CHROMA, cbf_cb);
    enc_bin(e, CTX_CBF_CHROMA, cbf_cr);
    enc_bin(e, CTX_CBF_LUMA + 1, cbf_y);
    if (cbf_y) encode_residual(e, ly, sa->ctb_log2, 0, 0);
    if (cbf_cb) encode_residual(e, lcb, sa->ctb_log2 - 1, 1, 0);
    if (cbf_cr) encode_residual(e, lcr, sa->ctb_log2 - 1, 2, 0);
}

static void enc_ctu_p(CabacEnc *e, const SliceArrays *sa, int i) {
    int cw = sa->ctbs_w;
    int c = i % cw, r = i / cw;
    int n = 1 << sa->ctb_log2;
    int ylen = n * n, clen = (n / 2) * (n / 2);
    int ct = sa->ctype[i];
    int ctx = 0;
    if (c > 0 && sa->skip[i - 1]) ctx++;
    if (r > 0 && sa->skip[i - cw]) ctx++;
    int is_skip = ct == CT_SKIP;
    enc_bin(e, CTX_CU_SKIP_FLAG + ctx, is_skip);
    if (is_skip) {
        enc_merge_idx(e, sa->merge_idxs ? sa->merge_idxs[i] : 0, sa->merge_k);
        return;
    }
    enc_bin(e, CTX_PRED_MODE_FLAG, ct == CT_INTRA);
    if (ct == CT_INTRA) {
        enc_bin(e, CTX_PART_MODE, 1);
        int cand_a = (c > 0 && sa->ctype[i - 1] == CT_INTRA) ? sa->intra_modes[i - 1] : 1;
        enc_luma_mode(e, sa->intra_modes[i], cand_a, 1);
        enc_bin(e, CTX_INTRA_CHROMA_PRED_MODE, 0);
    } else {
        enc_bin(e, CTX_PART_MODE, 1);
        enc_bin(e, CTX_MERGE_FLAG, ct == CT_MERGE);
        if (ct == CT_MERGE)
            enc_merge_idx(e, sa->merge_idxs ? sa->merge_idxs[i] : 0, sa->merge_k);
        if (ct == CT_AMVP) {
            enc_mvd(e, sa->mvds[2 * i], sa->mvds[2 * i + 1]);
            enc_bin(e, CTX_MVP_FLAG, sa->mvp_flags[i]);
        }
    }
    const int32_t *ly = sa->lev_y + (long)i * ylen;
    const int32_t *lcb = sa->lev_cb + (long)i * clen;
    const int32_t *lcr = sa->lev_cr + (long)i * clen;
    int cbf_cb = any_nonzero(lcb, clen), cbf_cr = any_nonzero(lcr, clen), cbf_y = any_nonzero(ly, ylen);
    int root_cbf = cbf_y || cbf_cb || cbf_cr;
    if (ct == CT_AMVP) enc_bin(e, CTX_RQT_ROOT_CBF, root_cbf);
    if (ct == CT_INTRA || root_cbf) {
        enc_bin(e, CTX_CBF_CHROMA, cbf_cb);
        enc_bin(e, CTX_CBF_CHROMA, cbf_cr);
        if (ct == CT_INTRA || cbf_cb || cbf_cr) enc_bin(e, CTX_CBF_LUMA + 1, cbf_y);
        if (cbf_y) encode_residual(e, ly, sa->ctb_log2, 0, 0);
        if (cbf_cb) encode_residual(e, lcb, sa->ctb_log2 - 1, 1, 0);
        if (cbf_cr) encode_residual(e, lcr, sa->ctb_log2 - 1, 2, 0);
    }
}

/* ---------------- WPP parallel row encoder ---------------- */

typedef struct {
    const SliceArrays *sa;
    int slice_type; /* 1 P, 2 I */
    int slice_qp;
    int row;
    uint8_t *out;      /* per-row buffer */
    long cap;
    long len;          /* result */
    uint8_t ctx_after1_state[NUM_CONTEXTS];
    uint8_t ctx_after1_mps[NUM_CONTEXTS];
    int ctx_after1_ready;
    pthread_mutex_t mu;
    pthread_cond_t cv;
    struct RowCtl *prev;
    int error;
} RowCtl;
typedef struct RowCtl RowCtlT;

static void *encode_row_thread(void *arg) {
    RowCtl *rc = (RowCtl *)arg;
    const SliceArrays *sa = rc->sa;
    int cw = sa->ctbs_w, chh = sa->ctbs_h;
    int nctu = cw * chh;
    CabacEnc e;
    enc_init(&e, rc->slice_type == 2 ? 0 : 1, rc->slice_qp, rc->out, rc->cap);
    if (rc->row > 0 && cw > 1) {
        RowCtl *prev = (RowCtl *)rc->prev;
        pthread_mutex_lock(&prev->mu);
        while (!prev->ctx_after1_ready) pthread_cond_wait(&prev->cv, &prev->mu);
        pthread_mutex_unlock(&prev->mu);
        memcpy(e.state, prev->ctx_after1_state, NUM_CONTEXTS);
        memcpy(e.mps, prev->ctx_after1_mps, NUM_CONTEXTS);
    }
    for (int c = 0; c < cw; c++) {
        int i = rc->row * cw + c;
        if (rc->slice_type == 2) enc_ctu_i(&e, sa, i);
        else enc_ctu_p(&e, sa, i);
        if (c == 1) {
            pthread_mutex_lock(&rc->mu);
            memcpy(rc->ctx_after1_state, e.state, NUM_CONTEXTS);
            memcpy(rc->ctx_after1_mps, e.mps, NUM_CONTEXTS);
            rc->ctx_after1_ready = 1;
            pthread_cond_signal(&rc->cv);
            pthread_mutex_unlock(&rc->mu);
        }
        int last = i == nctu - 1;
        enc_terminate(&e, last);
        if (!last && c == cw - 1) enc_terminate(&e, 1); /* end_of_subset */
    }
    if (cw == 1) { /* state still must be published for completeness */
        pthread_mutex_lock(&rc->mu);
        rc->ctx_after1_ready = 1;
        pthread_cond_signal(&rc->cv);
        pthread_mutex_unlock(&rc->mu);
    }
    while (e.out.nbits & 7) put_bit_raw(&e.out, 0);
    rc->len = e.out.error ? -1 : (e.out.nbits >> 3);
    rc->error = e.out.error;
    return NULL;
}

/* Unified entry: slice_type 2=I (wpp optional), 1=P.
 * wpp=0: single substream.  Returns total bytes; row lengths in row_lens
 * (ctbs_h entries when wpp, else 1). */
long encode_slice_c(
    int slice_type, int wpp,
    const int32_t *ctype, const int32_t *intra_modes, const int32_t *mvs,
    const int32_t *mvp_flags, const int32_t *mvds,
    const int32_t *lev_y, const int32_t *lev_cb, const int32_t *lev_cr,
    int ctbs_w, int ctbs_h, int ctb_log2, int at_min_cb, int slice_qp,
    uint8_t *out, long out_cap, long *row_lens,
    const int32_t *merge_idxs, int merge_k) {
    int nctu = ctbs_w * ctbs_h;
    uint8_t *skip = (uint8_t *)calloc(nctu, 1);
    if (slice_type == 1)
        for (int i = 0; i < nctu; i++) skip[i] = ctype[i] == CT_SKIP;
    SliceArrays sa = {ctype, intra_modes, mvs, mvp_flags, mvds,
                      lev_y, lev_cb, lev_cr, skip, ctbs_w, ctbs_h, ctb_log2,
                      at_min_cb, merge_idxs, merge_k ? merge_k : 1};
    long total = -1;
    if (!wpp) {
        CabacEnc e;
        enc_init(&e, slice_type == 2 ? 0 : 1, slice_qp, out, out_cap);
        for (int i = 0; i < nctu; i++) {
            if (slice_type == 2) enc_ctu_i(&e, &sa, i);
            else enc_ctu_p(&e, &sa, i);
            enc_terminate(&e, i == nctu - 1);
            if (e.out.error) goto done;
        }
        while (e.out.nbits & 7) put_bit_raw(&e.out, 0);
        row_lens[0] = e.out.nbits >> 3;
        total = row_lens[0];
        goto done;
    }
    {
        long per_cap = out_cap / ctbs_h;
        uint8_t *tmp = (uint8_t *)malloc((size_t)out_cap);
        RowCtl *rows = (RowCtl *)calloc(ctbs_h, sizeof(RowCtl));
        pthread_t *tids = (pthread_t *)malloc(sizeof(pthread_t) * ctbs_h);
        for (int r = 0; r < ctbs_h; r++) {
            rows[r].sa = &sa;
            rows[r].slice_type = slice_type;
            rows[r].slice_qp = slice_qp;
            rows[r].row = r;
            rows[r].out = tmp + (long)r * per_cap;
            rows[r].cap = per_cap;
            pthread_mutex_init(&rows[r].mu, NULL);
            pthread_cond_init(&rows[r].cv, NULL);
            rows[r].prev = r > 0 ? (struct RowCtl *)&rows[r - 1] : NULL;
        }
        int started = 0;
        for (int r = 0; r < ctbs_h; r++) {
            if (pthread_create(&tids[r], NULL, encode_row_thread, &rows[r]) != 0)
                break;  /* thread limit: finish the rest inline below */
            started++;
        }
        /* un-started rows run inline in ascending order — each waits only
           on its predecessor, which is either live or already run here */
        for (int r = started; r < ctbs_h; r++) encode_row_thread(&rows[r]);
        total = 0;
        int err = 0;
        for (int r = 0; r < ctbs_h; r++) {
            if (r < started) pthread_join(tids[r], NULL);
            if (rows[r].error || rows[r].len < 0) err = 1;
        }
        if (!err) {
            long pos = 0;
            for (int r = 0; r < ctbs_h; r++) {
                memcpy(out + pos, rows[r].out, rows[r].len);
                row_lens[r] = rows[r].len;
                pos += rows[r].len;
            }
            total = pos;
        }
        for (int r = 0; r < ctbs_h; r++) {
            pthread_mutex_destroy(&rows[r].mu);
            pthread_cond_destroy(&rows[r].cv);
        }
        free(tids);
        free(rows);
        free(tmp);
    }
done:
    free(skip);
    return total;
}

/* ---------------- unified decoder (sequential) ---------------- */

static int dec_ctu_i(CabacDec *d, SliceArrays *sa, int i,
                     int32_t *modes, int32_t *lev_y, int32_t *lev_cb, int32_t *lev_cr) {
    int cw = sa->ctbs_w;
    int c = i % cw;
    int n = 1 << sa->ctb_log2;
    int ylen = n * n, clen = (n / 2) * (n / 2);
    if (sa->at_min_cb && dec_bin(d, CTX_PART_MODE) != 1) return -10;
    int cand_a = c > 0 ? modes[i - 1] : 1;
    modes[i] = dec_luma_mode(d, cand_a, 1);
    if (dec_bin(d, CTX_INTRA_CHROMA_PRED_MODE) != 0) return -11;
    int cbf_cb = dec_bin(d, CTX_CBF_CHROMA);
    int cbf_cr = dec_bin(d, CTX_CBF_CHROMA);
    int cbf_y = dec_bin(d, CTX_CBF_LUMA + 1);
    if (cbf_y && decode_residual(d, lev_y + (long)i * ylen, sa->ctb_log2, 0, 0)) return -12;
    if (cbf_cb && decode_residual(d, lev_cb + (long)i * clen, sa->ctb_log2 - 1, 1, 0)) return -12;
    if (cbf_cr && decode_residual(d, lev_cr + (long)i * clen, sa->ctb_log2 - 1, 2, 0)) return -12;
    return 0;
}

static int dec_ctu_p(CabacDec *d, SliceArrays *sa, int i,
                     int32_t *ctype, int32_t *modes, int32_t *mvs, uint8_t *inter, uint8_t *skip,
                     int32_t *lev_y, int32_t *lev_cb, int32_t *lev_cr) {
    int cw = sa->ctbs_w;
    int c = i % cw, r = i / cw;
    int n = 1 << sa->ctb_log2;
    int ylen = n * n, clen = (n / 2) * (n / 2);
    int ctx = 0;
    if (c > 0 && skip[i - 1]) ctx++;
    if (r > 0 && skip[i - cw]) ctx++;
    int col_ok = sa->col_inter != NULL && sa->col_inter[i];
    int32_t col_x = col_ok ? sa->col_mv[2 * i] : 0;
    int32_t col_y = col_ok ? sa->col_mv[2 * i + 1] : 0;
    if (dec_bin(d, CTX_CU_SKIP_FLAG + ctx)) {
        skip[i] = 1;
        inter[i] = 1;
        ctype[i] = CT_SKIP;
        int idx = dec_merge_idx(d, sa->merge_k);
        int32_t list[5][2];
        merge_list_c(i, cw, inter, mvs, sa->merge_k, col_ok, col_x, col_y, list);
        mvs[2 * i] = list[idx][0]; mvs[2 * i + 1] = list[idx][1];
        return 0;
    }
    if (dec_bin(d, CTX_PRED_MODE_FLAG)) {
        ctype[i] = CT_INTRA;
        if (dec_bin(d, CTX_PART_MODE) != 1) return -10;
        int cand_a = (c > 0 && ctype[i - 1] == CT_INTRA) ? modes[i - 1] : 1;
        modes[i] = dec_luma_mode(d, cand_a, 1);
        if (dec_bin(d, CTX_INTRA_CHROMA_PRED_MODE) != 0) return -11;
    } else {
        inter[i] = 1;
        if (dec_bin(d, CTX_PART_MODE) != 1) return -10;
        if (dec_bin(d, CTX_MERGE_FLAG)) {
            ctype[i] = CT_MERGE;
            int idx = dec_merge_idx(d, sa->merge_k);
            int32_t list[5][2];
            merge_list_c(i, cw, inter, mvs, sa->merge_k, col_ok, col_x, col_y, list);
            mvs[2 * i] = list[idx][0]; mvs[2 * i + 1] = list[idx][1];
        } else {
            ctype[i] = CT_AMVP;
            int mvd_x, mvd_y;
            dec_mvd(d, &mvd_x, &mvd_y);
            int flag = dec_bin(d, CTX_MVP_FLAG);
            int32_t mvp0[2], mvp1[2];
            amvp_cands(i, cw, inter, mvs, col_ok, col_x, col_y, mvp0, mvp1);
            mvs[2 * i] = (flag ? mvp1[0] : mvp0[0]) + mvd_x;
            mvs[2 * i + 1] = (flag ? mvp1[1] : mvp0[1]) + mvd_y;
        }
    }
    int root_cbf = 1;
    if (ctype[i] == CT_AMVP) root_cbf = dec_bin(d, CTX_RQT_ROOT_CBF);
    if (ctype[i] == CT_INTRA || root_cbf) {
        int cbf_cb = dec_bin(d, CTX_CBF_CHROMA);
        int cbf_cr = dec_bin(d, CTX_CBF_CHROMA);
        int cbf_y = (ctype[i] == CT_INTRA || cbf_cb || cbf_cr) ? dec_bin(d, CTX_CBF_LUMA + 1) : 1;
        if (cbf_y && decode_residual(d, lev_y + (long)i * ylen, sa->ctb_log2, 0, 0)) return -12;
        if (cbf_cb && decode_residual(d, lev_cb + (long)i * clen, sa->ctb_log2 - 1, 1, 0)) return -12;
        if (cbf_cr && decode_residual(d, lev_cr + (long)i * clen, sa->ctb_log2 - 1, 2, 0)) return -12;
    }
    return 0;
}

/* entry_offsets: per-row byte lengths (ctbs_h-1 entries) when wpp */
int decode_slice_c(
    int slice_type, int wpp,
    const uint8_t *payload, long payload_len, const long *entry_offsets,
    int ctbs_w, int ctbs_h, int ctb_log2, int at_min_cb, int slice_qp,
    int32_t *ctype, int32_t *intra_modes, int32_t *mvs,
    int32_t *lev_y, int32_t *lev_cb, int32_t *lev_cr, int merge_k,
    const int32_t *col_mv, const uint8_t *col_inter) {
    int nctu = ctbs_w * ctbs_h;
    int n = 1 << ctb_log2;
    memset(lev_y, 0, sizeof(int32_t) * (long)nctu * n * n);
    memset(lev_cb, 0, sizeof(int32_t) * (long)nctu * (n / 2) * (n / 2));
    memset(lev_cr, 0, sizeof(int32_t) * (long)nctu * (n / 2) * (n / 2));
    memset(intra_modes, 0, sizeof(int32_t) * nctu);
    memset(mvs, 0, sizeof(int32_t) * 2 * nctu);
    if (ctype) memset(ctype, 0, sizeof(int32_t) * nctu);
    uint8_t *inter = (uint8_t *)calloc(nctu, 1);
    uint8_t *skip = (uint8_t *)calloc(nctu, 1);
    SliceArrays sa = {0};
    sa.ctbs_w = ctbs_w; sa.ctbs_h = ctbs_h; sa.ctb_log2 = ctb_log2; sa.at_min_cb = at_min_cb;
    sa.merge_k = merge_k ? merge_k : 1;
    sa.col_mv = col_mv; sa.col_inter = col_inter;
    int rc = 0;
    uint8_t saved_state[NUM_CONTEXTS], saved_mps[NUM_CONTEXTS];
    int have_saved = 0;
    long pos = 0;
    CabacDec d;
    int nrows = wpp ? ctbs_h : 1;
    for (int row = 0; row < nrows && rc == 0; row++) {
        long row_len = wpp
            ? (row < ctbs_h - 1 ? entry_offsets[row] : payload_len - pos)
            : payload_len;
        dec_init(&d, payload + pos, row_len, slice_type == 2 ? 0 : 1, slice_qp);
        if (wpp && row > 0 && ctbs_w > 1 && have_saved) {
            memcpy(d.state, saved_state, NUM_CONTEXTS);
            memcpy(d.mps, saved_mps, NUM_CONTEXTS);
        }
        int cbegin = wpp ? row * ctbs_w : 0;
        int cend = wpp ? (row + 1) * ctbs_w : nctu;
        for (int i = cbegin; i < cend && rc == 0; i++) {
            if (slice_type == 2) rc = dec_ctu_i(&d, &sa, i, intra_modes, lev_y, lev_cb, lev_cr);
            else rc = dec_ctu_p(&d, &sa, i, ctype, intra_modes, mvs, inter, skip, lev_y, lev_cb, lev_cr);
            if (rc) break;
            if (wpp && (i % ctbs_w) == 1) {
                memcpy(saved_state, d.state, NUM_CONTEXTS);
                memcpy(saved_mps, d.mps, NUM_CONTEXTS);
                have_saved = 1;
            }
            int end = dec_terminate(&d);
            int expected = (i == nctu - 1) ? 1 : 0;
            if (end != expected) { rc = -13; break; }
            if (wpp && i != nctu - 1 && (i % ctbs_w) == ctbs_w - 1) {
                if (dec_terminate(&d) != 1) { rc = -14; break; }
            }
        }
        pos += row_len;
    }
    free(inter);
    free(skip);
    return rc;
}

/* ==================================================================== */
/* CU quadtree (CTB16 -> 4x CU8) intra slice data                       */
/* Mirrors entropy/slice_data.py _encode/_decode_ctu_i_cu8 exactly.     */

static int resid_scan_intra(int mode, int log2, int c_idx) {
    /* 7.4.9.11: mode-dependent scan for small intra TBs
       (log2 == 2, or log2 == 3 luma): 6..14 -> vertical, 22..30 -> horiz */
    if (log2 == 2 || (log2 == 3 && c_idx == 0)) {
        if (mode >= 6 && mode <= 14) return 2;
        if (mode >= 22 && mode <= 30) return 1;
    }
    return 0;
}

/* copy z-quadrant k of an n x n array into dst ((n/2)^2) */
static void get_quad(const int32_t *src, int n, int k, int32_t *dst) {
    int h = n / 2;
    int r0 = (k >> 1) * h, c0 = (k & 1) * h;
    for (int r = 0; r < h; r++)
        for (int c = 0; c < h; c++) dst[r * h + c] = src[(r0 + r) * n + c0 + c];
}

static void put_quad(int32_t *dst, int n, int k, const int32_t *src) {
    int h = n / 2;
    int r0 = (k >> 1) * h, c0 = (k & 1) * h;
    for (int r = 0; r < h; r++)
        for (int c = 0; c < h; c++) dst[(r0 + r) * n + c0 + c] = src[r * h + c];
}

/* MPM candidates for sub-CU k of CTB i (z-order), matching _cu8_cands */
static void cu8_cands(const int32_t *modes8, int i, int k, int c, int *ca, int *cb) {
    switch (k) {
    case 0:
        *ca = c > 0 ? modes8[(i - 1) * 4 + 1] : 1;
        *cb = 1;
        break;
    case 1:
        *ca = modes8[i * 4 + 0];
        *cb = 1;
        break;
    case 2:
        *ca = c > 0 ? modes8[(i - 1) * 4 + 3] : 1;
        *cb = modes8[i * 4 + 0];
        break;
    default:
        *ca = modes8[i * 4 + 2];
        *cb = modes8[i * 4 + 1];
    }
}

long encode_slice_data_intra_cu8_c(
    const int32_t *split, const int32_t *modes8,
    const int32_t *lev_y, const int32_t *lev_cb, const int32_t *lev_cr,
    int nctu, int ctbs_w, int slice_qp, uint8_t *out, long out_cap) {
    CabacEnc e;
    enc_init(&e, 0, slice_qp, out, out_cap);
    int32_t q64[64], q16[16];
    for (int i = 0; i < nctu; i++) {
        int r = i / ctbs_w, c = i % ctbs_w;
        int ctx = (c > 0 && split[i - 1] ? 1 : 0) + (r > 0 && split[i - ctbs_w] ? 1 : 0);
        enc_bin(&e, CTX_SPLIT_CU_FLAG + ctx, split[i] ? 1 : 0);
        const int32_t *ly = lev_y + (long)i * 256;
        const int32_t *lcb = lev_cb + (long)i * 64;
        const int32_t *lcr = lev_cr + (long)i * 64;
        if (!split[i]) {
            int cand_a = c > 0 ? modes8[(i - 1) * 4 + 1] : 1;
            enc_luma_mode(&e, modes8[i * 4], cand_a, 1);
            enc_bin(&e, CTX_INTRA_CHROMA_PRED_MODE, 0);
            int cbf_cb = any_nonzero(lcb, 64), cbf_cr = any_nonzero(lcr, 64);
            int cbf_y = any_nonzero(ly, 256);
            enc_bin(&e, CTX_CBF_CHROMA, cbf_cb);
            enc_bin(&e, CTX_CBF_CHROMA, cbf_cr);
            enc_bin(&e, CTX_CBF_LUMA + 1, cbf_y);
            if (cbf_y && encode_residual(&e, ly, 4, 0, 0)) return -2;
            if (cbf_cb && encode_residual(&e, lcb, 3, 1, 0)) return -2;
            if (cbf_cr && encode_residual(&e, lcr, 3, 2, 0)) return -2;
        } else {
            for (int k = 0; k < 4; k++) {
                int mode = modes8[i * 4 + k];
                int ca, cb;
                cu8_cands(modes8, i, k, c, &ca, &cb);
                enc_bin(&e, CTX_PART_MODE, 1);
                enc_luma_mode(&e, mode, ca, cb);
                enc_bin(&e, CTX_INTRA_CHROMA_PRED_MODE, 0);
                get_quad(ly, 16, k, q64);
                int cbf_y = any_nonzero(q64, 64);
                get_quad(lcb, 8, k, q16);
                int cbf_cb = any_nonzero(q16, 16);
                int32_t q16r[16];
                get_quad(lcr, 8, k, q16r);
                int cbf_cr = any_nonzero(q16r, 16);
                enc_bin(&e, CTX_CBF_CHROMA, cbf_cb);
                enc_bin(&e, CTX_CBF_CHROMA, cbf_cr);
                enc_bin(&e, CTX_CBF_LUMA + 1, cbf_y);
                if (cbf_y && encode_residual(&e, q64, 3, 0, resid_scan_intra(mode, 3, 0)))
                    return -2;
                if (cbf_cb && encode_residual(&e, q16, 2, 1, resid_scan_intra(mode, 2, 1)))
                    return -2;
                if (cbf_cr && encode_residual(&e, q16r, 2, 2, resid_scan_intra(mode, 2, 2)))
                    return -2;
            }
        }
        enc_terminate(&e, i == nctu - 1);
        if (e.out.error) return -1;
    }
    while (e.out.nbits & 7) put_bit_raw(&e.out, 0);
    return e.out.nbits >> 3;
}

int decode_slice_data_intra_cu8_c(
    const uint8_t *payload, long payload_len,
    int nctu, int ctbs_w, int slice_qp,
    int32_t *split, int32_t *modes8,
    int32_t *lev_y, int32_t *lev_cb, int32_t *lev_cr) {
    CabacDec d;
    dec_init(&d, payload, payload_len, 0, slice_qp);
    memset(lev_y, 0, sizeof(int32_t) * (long)nctu * 256);
    memset(lev_cb, 0, sizeof(int32_t) * (long)nctu * 64);
    memset(lev_cr, 0, sizeof(int32_t) * (long)nctu * 64);
    int32_t q64[64], q16[16];
    for (int i = 0; i < nctu; i++) {
        int r = i / ctbs_w, c = i % ctbs_w;
        int ctx = (c > 0 && split[i - 1] ? 1 : 0) + (r > 0 && split[i - ctbs_w] ? 1 : 0);
        split[i] = dec_bin(&d, CTX_SPLIT_CU_FLAG + ctx);
        int32_t *ly = lev_y + (long)i * 256;
        int32_t *lcb = lev_cb + (long)i * 64;
        int32_t *lcr = lev_cr + (long)i * 64;
        if (!split[i]) {
            int cand_a = c > 0 ? modes8[(i - 1) * 4 + 1] : 1;
            int m = dec_luma_mode(&d, cand_a, 1);
            for (int k = 0; k < 4; k++) modes8[i * 4 + k] = m;
            if (dec_bin(&d, CTX_INTRA_CHROMA_PRED_MODE) != 0) return -11;
            int cbf_cb = dec_bin(&d, CTX_CBF_CHROMA);
            int cbf_cr = dec_bin(&d, CTX_CBF_CHROMA);
            int cbf_y = dec_bin(&d, CTX_CBF_LUMA + 1);
            if (cbf_y && decode_residual(&d, ly, 4, 0, 0)) return -12;
            if (cbf_cb && decode_residual(&d, lcb, 3, 1, 0)) return -12;
            if (cbf_cr && decode_residual(&d, lcr, 3, 2, 0)) return -12;
        } else {
            for (int k = 0; k < 4; k++) {
                if (dec_bin(&d, CTX_PART_MODE) != 1) return -10;
                int ca, cb;
                cu8_cands(modes8, i, k, c, &ca, &cb);
                int mode = dec_luma_mode(&d, ca, cb);
                modes8[i * 4 + k] = mode;
                if (dec_bin(&d, CTX_INTRA_CHROMA_PRED_MODE) != 0) return -11;
                int cbf_cb = dec_bin(&d, CTX_CBF_CHROMA);
                int cbf_cr = dec_bin(&d, CTX_CBF_CHROMA);
                int cbf_y = dec_bin(&d, CTX_CBF_LUMA + 1);
                if (cbf_y) {
                    memset(q64, 0, sizeof(q64));
                    if (decode_residual(&d, q64, 3, 0, resid_scan_intra(mode, 3, 0))) return -12;
                    put_quad(ly, 16, k, q64);
                }
                if (cbf_cb) {
                    memset(q16, 0, sizeof(q16));
                    if (decode_residual(&d, q16, 2, 1, resid_scan_intra(mode, 2, 1))) return -12;
                    put_quad(lcb, 8, k, q16);
                }
                if (cbf_cr) {
                    memset(q16, 0, sizeof(q16));
                    if (decode_residual(&d, q16, 2, 2, resid_scan_intra(mode, 2, 2))) return -12;
                    put_quad(lcr, 8, k, q16);
                }
            }
        }
        int end = dec_terminate(&d);
        if (end != ((i == nctu - 1) ? 1 : 0)) return -13;
    }
    return 0;
}

/* ==================================================================== */
/* Generic quadtree parser (openHEVC-replacement scope)                 */
/*                                                                      */
/* Parses a full generic slice segment — any CTB size, CU/TU quadtrees, */
/* NxN/AMP partitions, PCM, SDH, transform-skip, SAO, cu_qp_delta,      */
/* P/B inter syntax — into a REPLAY record: every structural bin value  */
/* in decode order (bins[]), residual blocks as level arrays (levs[] +  */
/* per-call tsflag meta[]), and raw PCM samples (pcm[]).  The Python    */
/* generic tier (decoder/generic_*.py) then re-runs its unchanged       */
/* decode logic against a ReplayDecoder that pops these values — no     */
/* CABAC math on the Python side.  Grammar mirrors generic_intra.py /   */
/* generic_inter.py / generic_b.py element for element.                 */

/* Recon mode (decode-side reconstruction in C, openHEVC-class): when
   GP.rc is set the walker reconstructs pixels/maps directly into the
   Python decoder's numpy buffers instead of emitting a replay record. */
typedef struct {
    int32_t *y, *u, *v;                 /* canvases h*w, (h/2)*(w/2) */
    int32_t *qp4;                       /* h4*w4 */
    uint8_t *edge_v, *edge_h;           /* h8*w8 deblock edge marks */
    int32_t *inter4, *ref4, *refpoc4, *cbf4;  /* h4*w4 (P/B) */
    int32_t *mv4;                       /* h4*w4*2 (L0 view) */
    uint8_t *pf4;                       /* h4*w4*2 (B) */
    int32_t *mv4l;                      /* h4*w4*2*2 (B) */
    int32_t *refpoc4l;                  /* h4*w4*2 (B) */
    int32_t *sao_typ, *sao_aux, *sao_offs;  /* 3*nctb, 3*nctb, 3*nctb*4 */
    const int64_t *ref0, *ref1;         /* plane addresses, 3 per ref pic */
    const int32_t *ref0_poc, *ref1_poc;
    const int32_t *col_inter4, *col_mv4, *col_refpoc4;
    const int32_t *wt;                  /* weights or NULL (layout: see
                                           recon_generic_slice_c) */
    int has_col, col_poc, cur_poc;
    int strong_smoothing, cb_off, cr_off;
    int w2, h2, w8, h8;
    /* QP chain state (8.6.1) */
    int qp, qp_y, qp_cb, qp_cr, qp_prev, slice_qp, qg_pred;
} RC;

typedef struct {
    CabacDec d;
    uint8_t *bins; long bins_cap, bins_n;
    int32_t *levs; long levs_cap, levs_n;
    int32_t *meta; long meta_cap, meta_n;
    int32_t *pcm;  long pcm_cap, pcm_n;
    int err;
    int w, h, cl, min_cb, min_tb, max_tb, td_intra, td_inter;
    int amp, sdh, tskip, cuqp, qg_log2;
    int pcm_min, pcm_max, pcm_bd, pcm_bd_c;
    int slice_type, nref0, nref1, max_merge, mvd_l1_zero;
    int sao_luma, sao_chroma;
    int cw, ch, w4, h4;
    int32_t *depth4, *skip4, *mode4;
    const int32_t *slice_of; int cur_slice;
    int delta_pending; long qg_key;
    RC *rc;
} GP;

static void gp_emit(GP *g, int v) {
    if (!g->bins) return;  /* recon mode: no replay record */
    if (g->bins_n >= g->bins_cap) { g->err = -20; return; }
    g->bins[g->bins_n++] = (uint8_t)v;
}
static int gp_bin(GP *g, int ctx) { int v = dec_bin(&g->d, ctx); gp_emit(g, v); return v; }
static int gp_byp(GP *g) { int v = dec_bypass(&g->d); gp_emit(g, v); return v; }
static uint32_t gp_byp_bits(GP *g, int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 1) | (uint32_t)gp_byp(g);
    return v;
}
static int gp_term(GP *g) { int v = dec_terminate(&g->d); gp_emit(g, v); return v; }

static int gp_same_slice(GP *g, int x, int y) {
    if (!g->slice_of) return 1;
    long i = ((long)(y >> g->cl)) * g->cw + (x >> g->cl);
    return g->slice_of[i] == g->cur_slice;
}

/* ---- residual_coding (7.3.8.11) into a caller buffer ---- */
static void gp_residual_into(GP *g, int log2, int c_idx, int scan_idx,
                             int32_t *coeffs, int *ts_out) {
    CabacDec *d = &g->d;
    int ts_flag = 0;
    if (g->tskip && log2 == 2)
        ts_flag = dec_bin(d, CTX_TRANSFORM_SKIP_FLAG + (c_idx ? 1 : 0));
    *ts_out = ts_flag;
    int n = 1 << log2;

    int pos4[16], sbpos[64];
    int nsb_dim = n >> 2; if (nsb_dim < 1) nsb_dim = 1;
    get_scan(scan_idx, 4, pos4);
    get_scan(scan_idx, nsb_dim, sbpos);
    memset(coeffs, 0, sizeof(int32_t) * n * n);

    int cmax = (log2 << 1) - 1;
    int pref_x = 0, pref_y = 0;
    while (pref_x < cmax && dec_bin(d, CTX_LAST_SIG_COEFF_X_PREFIX + last_prefix_ctx(log2, c_idx, pref_x))) pref_x++;
    while (pref_y < cmax && dec_bin(d, CTX_LAST_SIG_COEFF_Y_PREFIX + last_prefix_ctx(log2, c_idx, pref_y))) pref_y++;
    int last_x, last_y;
    if (pref_x > 3) { int nb = (pref_x >> 1) - 1; last_x = (int)(((2 + (pref_x & 1)) << nb) + dec_bypass_bits(d, nb)); }
    else last_x = pref_x;
    if (pref_y > 3) { int nb = (pref_y >> 1) - 1; last_y = (int)(((2 + (pref_y & 1)) << nb) + dec_bypass_bits(d, nb)); }
    else last_y = pref_y;
    if (scan_idx == 2) { int t = last_x; last_x = last_y; last_y = t; }

    int last_pos = -1;
    int nsb = nsb_dim * nsb_dim;
    for (int i = 0; i < nsb && last_pos < 0; i++) {
        int sb = sbpos[i];
        int sx = sb % nsb_dim, sy = sb / nsb_dim;
        for (int k = 0; k < 16; k++) {
            int px = pos4[k] % 4, py = pos4[k] / 4;
            if ((sx << 2) + px == last_x && (sy << 2) + py == last_y) { last_pos = i * 16 + k; break; }
        }
    }
    if (last_pos < 0) { g->err = -23; return; }
    int last_sb = last_pos >> 4, last_scan = last_pos & 15;

    uint8_t csbf[64];
    memset(csbf, 0, sizeof csbf);
    int prev_c1 = 1;
    for (int i = last_sb; i >= 0; i--) {
        int sb = sbpos[i];
        int sx = sb % nsb_dim, sy = sb / nsb_dim;
        int infer_dc = 0, coded;
        if (i > 0 && i < last_sb) {
            int ctx = 0;
            if (sx < nsb_dim - 1) ctx += csbf[sy * nsb_dim + sx + 1];
            if (sy < nsb_dim - 1) ctx += csbf[(sy + 1) * nsb_dim + sx];
            coded = dec_bin(d, CTX_CODED_SUB_BLOCK_FLAG + (ctx > 1 ? 1 : ctx) + (c_idx ? 2 : 0));
            infer_dc = 1;
        } else coded = 1;
        csbf[sy * nsb_dim + sx] = (uint8_t)coded;
        if (!coded) continue;

        int sig[16];
        memset(sig, 0, sizeof sig);
        int start = (i == last_sb) ? last_scan - 1 : 15;
        if (i == last_sb) sig[last_scan] = 1;
        for (int k = start; k >= 0; k--) {
            if (k > 0 || !infer_dc) {
                int px = pos4[k] % 4, py = pos4[k] / 4;
                sig[k] = dec_bin(d, sig_ctx(log2, c_idx, scan_idx, (sx << 2) + px, (sy << 2) + py, csbf, nsb_dim));
                if (sig[k]) infer_dc = 0;
            } else sig[0] = 1;
        }

        int sig_pos[16], nsig = 0;
        int kmax = (i == last_sb) ? last_scan : 15;
        for (int k = kmax; k >= 0; k--) if (sig[k]) sig_pos[nsig++] = k;
        if (!nsig) continue;
        int ctx_set = ((i > 0 && c_idx == 0) ? 2 : 0) + (prev_c1 == 0 ? 1 : 0);
        int c1 = 1;
        int g1_base = CTX_COEFF_ABS_LEVEL_GREATER1_FLAG + (c_idx ? 16 : 0);
        int g2_base = CTX_COEFF_ABS_LEVEL_GREATER2_FLAG + (c_idx ? 4 : 0);
        int num_g1 = nsig < 8 ? nsig : 8;
        int g1_flag[16], has_g1[16], g2_val = 0, has_g2 = 0, first_g1 = -1;
        memset(has_g1, 0, sizeof has_g1);
        for (int idx = 0; idx < num_g1; idx++) {
            int k = sig_pos[idx];
            int flag = dec_bin(d, g1_base + ctx_set * 4 + c1);
            g1_flag[k] = flag; has_g1[k] = 1;
            if (flag) { if (first_g1 < 0) first_g1 = k; c1 = 0; }
            else if (c1 > 0 && c1 < 3) c1++;
        }
        if (first_g1 >= 0) { g2_val = dec_bin(d, g2_base + ctx_set); has_g2 = 1; }
        /* sign data hiding: sign of the lowest sig position inferred */
        int sign_hidden = g->sdh && (sig_pos[0] - sig_pos[nsig - 1] > 3);
        int sign[16];
        int ncoded = sign_hidden ? nsig - 1 : nsig;
        for (int idx = 0; idx < ncoded; idx++) sign[idx] = dec_bypass(d);
        int rice = 0;
        int64_t abs_sum = 0;
        int32_t absv[16];
        for (int idx = 0; idx < nsig; idx++) {
            int k = sig_pos[idx];
            int g1 = has_g1[k] ? g1_flag[k] : 0;
            int g2 = (has_g2 && k == first_g1) ? g2_val : 0;
            int base_level = 1 + g1 + g2;
            int saturated = (idx >= 8) || (has_g1[k] && g1 == 1 && !(has_g2 && k == first_g1)) || g2 == 1;
            int32_t a = base_level;
            if (saturated) {
                a = base_level + (int32_t)dec_remaining(d, rice);
                if (a > (3 << rice) && rice < 4) rice++;
            }
            absv[idx] = a;
            abs_sum += a;
        }
        if (sign_hidden) sign[nsig - 1] = (int)(abs_sum & 1);
        for (int idx = 0; idx < nsig; idx++) {
            int k = sig_pos[idx];
            int px = pos4[k] % 4, py = pos4[k] / 4;
            coeffs[((sy << 2) + py) * n + (sx << 2) + px] = sign[idx] ? -absv[idx] : absv[idx];
        }
        prev_c1 = c1;
    }
}

/* arena wrapper (replay/parse mode) */
static void gp_residual(GP *g, int log2, int c_idx, int scan_idx) {
    if (g->meta_n >= g->meta_cap) { g->err = -21; return; }
    int n = 1 << log2;
    if (g->levs_n + (long)n * n > g->levs_cap) { g->err = -22; return; }
    int32_t *coeffs = g->levs + g->levs_n;
    g->levs_n += (long)n * n;
    int tsf = 0;
    gp_residual_into(g, log2, c_idx, scan_idx, coeffs, &tsf);
    g->meta[g->meta_n++] = tsf;
}

/* ---- helpers mirroring the Python generic tier ---- */

static void gp_cands(GP *g, int x0, int y0, int *a, int *b) {
    int cl1 = 1 << g->cl;
    if (x0 == 0 || !gp_same_slice(g, x0 - 1, y0)) *a = 1;
    else *a = g->mode4[(long)(y0 >> 2) * g->w4 + ((x0 - 1) >> 2)];
    if (y0 == 0 || ((y0 - 1) / cl1) != (y0 / cl1)) *b = 1;
    else *b = g->mode4[(long)((y0 - 1) >> 2) * g->w4 + (x0 >> 2)];
}

static int gp_luma_mode(GP *g, int x0, int y0) {
    int a, b, mpm[3];
    gp_cands(g, x0, y0, &a, &b);
    mpm_list(a, b, mpm);
    if (gp_bin(g, CTX_PREV_INTRA_LUMA_PRED_FLAG)) {
        int idx = 0;
        if (gp_byp(g)) idx = 1 + gp_byp(g);
        return mpm[idx];
    }
    int rem = (int)gp_byp_bits(g, 5);
    int s[3] = {mpm[0], mpm[1], mpm[2]};
    for (int i = 0; i < 2; i++) for (int j = i + 1; j < 3; j++) if (s[j] < s[i]) { int t = s[i]; s[i] = s[j]; s[j] = t; }
    for (int i = 0; i < 3; i++) if (rem >= s[i]) rem++;
    return rem;
}

/* mode-tail only (NxN: the four prev flags precede the four tails) */
static int gp_luma_mode_tail(GP *g, int a, int b, int prev) {
    int mpm[3];
    mpm_list(a, b, mpm);
    if (prev) {
        int idx = 0;
        if (gp_byp(g)) idx = 1 + gp_byp(g);
        return mpm[idx];
    }
    int rem = (int)gp_byp_bits(g, 5);
    int s[3] = {mpm[0], mpm[1], mpm[2]};
    for (int i = 0; i < 2; i++) for (int j = i + 1; j < 3; j++) if (s[j] < s[i]) { int t = s[i]; s[i] = s[j]; s[j] = t; }
    for (int i = 0; i < 3; i++) if (rem >= s[i]) rem++;
    return rem;
}

static int gp_chroma_mode(GP *g, int luma_mode) {
    static const int cand_tab[4] = {0, 26, 10, 1};
    if (gp_bin(g, CTX_INTRA_CHROMA_PRED_MODE) == 0) return luma_mode;
    int idx = (gp_byp(g) << 1) | gp_byp(g);
    int cand = cand_tab[idx];
    return cand == luma_mode ? 34 : cand;
}

static int gp_read_egk(GP *g, int k) {
    int v = 0;
    while (gp_byp(g)) { v += 1 << k; k++; }
    return v + (int)gp_byp_bits(g, k);
}

static void gp_mvd(GP *g, int *mx, int *my) {
    int g0x = gp_bin(g, CTX_ABS_MVD_GREATER_FLAG);
    int g0y = gp_bin(g, CTX_ABS_MVD_GREATER_FLAG);
    int g1x = g0x ? gp_bin(g, CTX_ABS_MVD_GREATER_FLAG + 1) : 0;
    int g1y = g0y ? gp_bin(g, CTX_ABS_MVD_GREATER_FLAG + 1) : 0;
    int out[2] = {0, 0};
    int gg0[2] = {g0x, g0y}, gg1[2] = {g1x, g1y};
    for (int i = 0; i < 2; i++) {
        int a = 0;
        if (gg0[i]) {
            a = 1;
            if (gg1[i]) a = 2 + gp_read_egk(g, 1);
            if (gp_byp(g)) a = -a;
        }
        out[i] = a;
    }
    *mx = out[0]; *my = out[1];
}

static int gp_merge_idx(GP *g) {
    int idx = 0;
    if (g->max_merge > 1) {
        if (gp_bin(g, CTX_MERGE_IDX)) {
            idx = 1;
            while (idx < g->max_merge - 1 && gp_byp(g)) idx++;
        }
    }
    return idx;
}

static int gp_ref_idx(GP *g, int nref) {
    if (nref <= 1) return 0;
    if (!gp_bin(g, CTX_REF_IDX)) return 0;
    int idx = 1;
    if (nref > 2) {
        if (gp_bin(g, CTX_REF_IDX + 1)) {
            idx = 2;
            while (idx < nref - 1 && gp_byp(g)) idx++;
        }
    }
    return idx;
}

static int gp_qp_delta(GP *g) {
    int prefix = 0;
    while (prefix < 5 && gp_bin(g, CTX_CU_QP_DELTA_ABS + (prefix == 0 ? 0 : 1))) prefix++;
    int a = prefix;
    if (prefix >= 5) a = 5 + gp_read_egk(g, 0);
    if (a && gp_byp(g)) return -a;
    return a;
}

static void rc_set_qp(GP *g, int qp);

static void gp_maybe_qp_delta(GP *g) {
    if (g->cuqp && g->delta_pending) {
        g->delta_pending = 0;
        int delta = gp_qp_delta(g);
        if (g->rc) {
            int q = g->rc->qg_pred + delta + 52;
            rc_set_qp(g, ((q % 52) + 52) % 52);
        }
    }
}

static void gp_enter_qg(GP *g, int x0, int y0) {
    long key = ((long)(y0 >> g->qg_log2) << 20) | (x0 >> g->qg_log2);
    if (key == g->qg_key) return;
    g->qg_key = key;
    g->delta_pending = 1;
    RC *rc = g->rc;
    if (rc) {
        /* quant-group QP prediction (8.6.1) */
        int xqg = (x0 >> g->qg_log2) << g->qg_log2;
        int yqg = (y0 >> g->qg_log2) << g->qg_log2;
        int cl1 = 1 << g->cl;
        int qp_a = (xqg % cl1 != 0)
            ? rc->qp4[((long)(yqg >> 2)) * g->w4 + ((xqg - 1) >> 2)] : rc->qp_prev;
        int qp_b = (yqg % cl1 != 0)
            ? rc->qp4[((long)((yqg - 1) >> 2)) * g->w4 + (xqg >> 2)] : rc->qp_prev;
        rc->qg_pred = (qp_a + qp_b + 1) >> 1;
        rc_set_qp(g, rc->qg_pred);
    }
}

/* ---- SAO (7.3.8.3); recon mode also decodes params into the arrays ---- */
static void sao_copy(GP *g, long dst, long src) {
    RC *rc = g->rc;
    long n = (long)g->cw * g->ch;
    for (int c = 0; c < 3; c++) {
        rc->sao_typ[c * n + dst] = rc->sao_typ[c * n + src];
        rc->sao_aux[c * n + dst] = rc->sao_aux[c * n + src];
        for (int k = 0; k < 4; k++)
            rc->sao_offs[(c * n + dst) * 4 + k] = rc->sao_offs[(c * n + src) * 4 + k];
    }
}

static void gp_sao(GP *g, long i, int prev_chroma_type[1]) {
    RC *rc = g->rc;
    long nctb = (long)g->cw * g->ch;
    int c = (int)(i % g->cw), r = (int)(i / g->cw);
    if (c > 0) {
        int avail_l = (g->slice_of == NULL) || (g->slice_of[i - 1] == g->slice_of[i]);
        if (avail_l && gp_bin(g, CTX_SAO_MERGE_FLAG)) {
            if (rc) sao_copy(g, i, i - 1);
            return;
        }
    }
    if (r > 0) {
        int avail_u = (g->slice_of == NULL) || (g->slice_of[i - g->cw] == g->slice_of[i]);
        if (avail_u && gp_bin(g, CTX_SAO_MERGE_FLAG)) {
            if (rc) sao_copy(g, i, i - g->cw);
            return;
        }
    }
    int chroma_t = 0;
    for (int cidx = 0; cidx < 3; cidx++) {
        if ((cidx == 0 && !g->sao_luma) || (cidx > 0 && !g->sao_chroma)) continue;
        int t;
        if (cidx != 2) {
            t = 0;
            if (gp_bin(g, CTX_SAO_TYPE_IDX)) t = gp_byp(g) ? 2 : 1;
            if (cidx == 1) chroma_t = t;
        } else t = chroma_t;
        if (rc) rc->sao_typ[cidx * nctb + i] = t;
        if (t == 0) continue;
        int absv[4];
        for (int k = 0; k < 4; k++) {
            int v = 0;
            while (v < 7 && gp_byp(g)) v++;
            absv[k] = v;
        }
        if (t == 1) {
            int offs[4];
            for (int k = 0; k < 4; k++) {
                int s = absv[k] ? gp_byp(g) : 0;
                offs[k] = s ? -absv[k] : absv[k];
            }
            int band = (int)gp_byp_bits(g, 5);
            if (rc) {
                for (int k = 0; k < 4; k++)
                    rc->sao_offs[(cidx * nctb + i) * 4 + k] = offs[k];
                rc->sao_aux[cidx * nctb + i] = band;
            }
        } else {
            int eo = -1;
            if (cidx != 2) eo = (int)gp_byp_bits(g, 2);
            if (rc) {
                rc->sao_offs[(cidx * nctb + i) * 4 + 0] = absv[0];
                rc->sao_offs[(cidx * nctb + i) * 4 + 1] = absv[1];
                rc->sao_offs[(cidx * nctb + i) * 4 + 2] = -absv[2];
                rc->sao_offs[(cidx * nctb + i) * 4 + 3] = -absv[3];
                rc->sao_aux[cidx * nctb + i] =
                    (cidx != 2) ? eo : rc->sao_aux[1 * nctb + i];
            }
        }
    }
    (void)prev_chroma_type;
}

/* ---- PCM (7.3.8.7): align, raw reads (arena or canvases), re-init ---- */
static void gp_pcm(GP *g, int x0, int y0, int log2) {
    CabacDec *d = &g->d;
    d->bitpos = ((d->bitpos + 7) / 8) * 8;
    int n = 1 << log2, nc = n >> 1;
    RC *rc = g->rc;
    if (!rc) {
        long count = (long)n * n + 2L * nc * nc;
        if (g->pcm_n + count > g->pcm_cap) { g->err = -24; return; }
        for (long j = 0; j < (long)n * n; j++) {
            uint32_t v = 0;
            for (int b = 0; b < g->pcm_bd; b++) v = (v << 1) | (uint32_t)dec_read_bit(d);
            g->pcm[g->pcm_n++] = (int32_t)v;
        }
        for (long j = 0; j < 2L * nc * nc; j++) {
            uint32_t v = 0;
            for (int b = 0; b < g->pcm_bd_c; b++) v = (v << 1) | (uint32_t)dec_read_bit(d);
            g->pcm[g->pcm_n++] = (int32_t)v;
        }
    } else {
        int sh = 8 - g->pcm_bd, shc = 8 - g->pcm_bd_c;
        for (int r = 0; r < n; r++)
            for (int c = 0; c < n; c++) {
                uint32_t v = 0;
                for (int b = 0; b < g->pcm_bd; b++) v = (v << 1) | (uint32_t)dec_read_bit(d);
                rc->y[(long)(y0 + r) * g->w + x0 + c] = (int32_t)(v << sh);
            }
        int xc = x0 >> 1, yc = y0 >> 1;
        int32_t *planes[2] = {rc->u, rc->v};
        for (int p = 0; p < 2; p++)
            for (int r = 0; r < nc; r++)
                for (int c = 0; c < nc; c++) {
                    uint32_t v = 0;
                    for (int b = 0; b < g->pcm_bd_c; b++) v = (v << 1) | (uint32_t)dec_read_bit(d);
                    planes[p][(long)(yc + r) * rc->w2 + xc + c] = (int32_t)(v << shc);
                }
    }
    /* re-init arithmetic engine; contexts persist (9.3.1) */
    d->range = 510; d->offset = 0;
    for (int j = 0; j < 9; j++) d->offset = (d->offset << 1) | dec_read_bit(d);
}

/* ==================================================================== */
/* Reconstruction toolbox (recon mode): intra prediction 8.4.4, dequant */
/* 8.6.3, inverse transform 8.6.4, MC 8.5.4, motion derivation 8.5.3.   */
/* Ports the repo's OWN Python generic tier (decoder/generic_*.py,      */
/* ops/intra.py, ops/transforms.py, ops/quant.py, ops/mc.py) to C;      */
/* bit depth 8, flat scaling lists (callers gate).                      */

static void rc_set_qp(GP *g, int qp) {
    RC *rc = g->rc;
    rc->qp = qp;
    rc->qp_y = qp;  /* QpBdOffset = 0 at 8 bit */
    int qpi = qp + rc->cb_off;
    qpi = qpi < 0 ? 0 : qpi > 57 ? 57 : qpi;
    rc->qp_cb = CHROMA_QP_TABLE[qpi];
    qpi = qp + rc->cr_off;
    qpi = qpi < 0 ? 0 : qpi > 57 ? 57 : qpi;
    rc->qp_cr = CHROMA_QP_TABLE[qpi];
}

/* z-scan order of the 4x4 cell holding pixel (x, y) of a plane (6.4.1) */
static long rc_zaddr(GP *g, int x, int y, int chroma) {
    if (chroma) { x <<= 1; y <<= 1; }
    int cl = g->cl;
    long ctb = ((long)(y >> cl)) * g->cw + (x >> cl);
    int r4 = (y & ((1 << cl) - 1)) >> 2;
    int c4 = (x & ((1 << cl) - 1)) >> 2;
    int bits = cl - 2;
    long z = 0;
    for (int b = bits - 1; b >= 0; b--)
        z = (z << 2) | (((long)((r4 >> b) & 1) << 1) | ((c4 >> b) & 1));
    return (ctb << (2 * bits)) + z;
}

static int rc_same_slice(GP *g, int x, int y, int chroma) {
    if (!g->slice_of) return 1;
    if (chroma) { x <<= 1; y <<= 1; }
    long i = ((long)(y >> g->cl)) * g->cw + (x >> g->cl);
    return g->slice_of[i] == g->cur_slice;
}

/* CU/TU boundary marks on the 8-pel grid (generic_intra._mark_edges) */
static void rc_mark_edges(GP *g, int x0, int y0, int n) {
    RC *rc = g->rc;
    if (!rc) return;
    if ((x0 & 7) == 0 && (x0 >> 3) < rc->w8) {
        int r1 = y0 >> 3, r2 = (y0 + n + 7) >> 3;
        if (r2 > rc->h8) r2 = rc->h8;
        for (int r = r1; r < r2; r++) rc->edge_v[(long)r * rc->w8 + (x0 >> 3)] = 1;
    }
    if ((y0 & 7) == 0 && (y0 >> 3) < rc->h8) {
        int c1 = x0 >> 3, c2 = (x0 + n + 7) >> 3;
        if (c2 > rc->w8) c2 = rc->w8;
        for (int c = c1; c < c2; c++) rc->edge_h[(long)(y0 >> 3) * rc->w8 + c] = 1;
    }
}

/* boundary walk A[0..4N]: below-left+left bottom-up, corner, top+top-right */
static void rc_boundary(GP *g, const int32_t *canvas, int W, int H,
                        int x0, int y0, int n, int chroma,
                        int32_t *a, uint8_t *av) {
    long cur = rc_zaddr(g, x0, y0, chroma);
    memset(a, 0, sizeof(int32_t) * (4 * n + 1));
    memset(av, 0, (size_t)(4 * n + 1));
    for (int j = 0; j < 2 * n; j++) {
        int x = x0 - 1, y = y0 + 2 * n - 1 - j;
        if (x >= 0 && y >= 0 && x < W && y < H && rc_zaddr(g, x, y, chroma) < cur
                && rc_same_slice(g, x, y, chroma)) {
            a[j] = canvas[(long)y * W + x]; av[j] = 1;
        }
    }
    if (x0 - 1 >= 0 && y0 - 1 >= 0 && rc_zaddr(g, x0 - 1, y0 - 1, chroma) < cur
            && rc_same_slice(g, x0 - 1, y0 - 1, chroma)) {
        a[2 * n] = canvas[(long)(y0 - 1) * W + x0 - 1]; av[2 * n] = 1;
    }
    for (int j = 0; j < 2 * n; j++) {
        int x = x0 + j, y = y0 - 1;
        if (x >= 0 && y >= 0 && x < W && y < H && rc_zaddr(g, x, y, chroma) < cur
                && rc_same_slice(g, x, y, chroma)) {
            a[2 * n + 1 + j] = canvas[(long)y * W + x]; av[2 * n + 1 + j] = 1;
        }
    }
}

/* reference sample substitution (8.4.4.2.2) */
static void rc_substitute(int32_t *a, const uint8_t *av, int ln) {
    int first = -1;
    for (int j = 0; j < ln; j++) if (av[j]) { first = j; break; }
    if (first < 0) {
        for (int j = 0; j < ln; j++) a[j] = 128;
        return;
    }
    int32_t last = a[first];
    for (int j = 0; j < ln; j++) {
        if (av[j]) last = a[j];
        else a[j] = last;
    }
    for (int j = 0; j < first; j++) a[j] = a[first];
}

static void rc_filter_refs(const int32_t *a, int32_t *af, int ln) {
    af[0] = a[0];
    for (int j = 1; j < ln - 1; j++)
        af[j] = (a[j - 1] + 2 * a[j] + a[j + 1] + 2) >> 2;
    af[ln - 1] = a[ln - 1];
}

static void rc_strong_filter_refs(const int32_t *a, int32_t *af, int log2) {
    int n = 1 << log2;
    for (int j = 0; j <= 2 * n; j++) {
        int32_t left = (a[0] * (2 * n - j) + a[2 * n] * j + n) >> (log2 + 1);
        if (j < 2 * n) af[j] = left;
        int32_t top = (a[2 * n] * (2 * n - j) + a[4 * n] * j + n) >> (log2 + 1);
        af[2 * n + j] = top;
    }
}

static int rc_filter_flag(int mode, int n, int is_luma) {
    if (!is_luma || mode == 1 || n == 4) return 0;
    int d26 = mode - 26; if (d26 < 0) d26 = -d26;
    int d10 = mode - 10; if (d10 < 0) d10 = -d10;
    int md = d26 < d10 ? d26 : d10;
    int thr = (n == 8) ? 7 : (n == 16) ? 1 : (n == 32) ? 0 : (1 << 30);
    return md > thr;
}

/* single-mode intra prediction (ops/intra.py predict_mode semantics) */
static void rc_predict(GP *g, const int32_t *canvas, int W, int H,
                       int x0, int y0, int log2, int is_luma, int mode,
                       int chroma, int32_t *out) {
    int n = 1 << log2;
    int32_t a[129], af[129];
    uint8_t av[129];
    rc_boundary(g, canvas, W, H, x0, y0, n, chroma, a, av);
    rc_substitute(a, av, 4 * n + 1);
    int strong = 0;
    if (is_luma && g->rc->strong_smoothing && log2 == 5) {
        int thr = 1 << 3;
        int d1 = a[2 * n] + a[4 * n] - 2 * a[3 * n]; if (d1 < 0) d1 = -d1;
        int d2 = a[2 * n] + a[0] - 2 * a[n]; if (d2 < 0) d2 = -d2;
        strong = d1 < thr && d2 < thr;
    }
    if (is_luma) {
        if (strong) rc_strong_filter_refs(a, af, log2);
        else rc_filter_refs(a, af, 4 * n + 1);
    } else memcpy(af, a, sizeof(int32_t) * (4 * n + 1));
    const int32_t *top = a + 2 * n + 1;      /* top[x], x = 0..n-1 */
    int32_t corner = a[2 * n];
    /* left[y] = a[2n-1-y] */
    if (mode == 0) {  /* planar (8.4.4.2.4) */
        int use_f = is_luma && n >= 8;
        const int32_t *S = use_f ? af : a;
        int32_t tr = S[3 * n + 1], bl = S[n - 1];
        for (int y = 0; y < n; y++) {
            int32_t pl = S[2 * n - 1 - y];
            for (int x = 0; x < n; x++) {
                int32_t pt = S[2 * n + 1 + x];
                out[y * n + x] = ((n - 1 - x) * pl + (x + 1) * tr
                                  + (n - 1 - y) * pt + (y + 1) * bl + n)
                                 >> (log2 + 1);
            }
        }
        return;
    }
    if (mode == 1) {  /* DC (8.4.4.2.5) */
        long s = 0;
        for (int j = 0; j < n; j++) s += top[j] + a[2 * n - 1 - j];
        int32_t dc = (int32_t)((s + n) >> (log2 + 1));
        for (int j = 0; j < n * n; j++) out[j] = dc;
        if (is_luma && n < 32) {
            for (int x = 0; x < n; x++) out[x] = (top[x] + 3 * dc + 2) >> 2;
            for (int y = 0; y < n; y++) out[y * n] = (a[2 * n - 1 - y] + 3 * dc + 2) >> 2;
            out[0] = (a[2 * n - 1] + 2 * dc + top[0] + 2) >> 2;
        }
        return;
    }
    /* angular 2..34 (8.4.4.2.6) */
    int filt = rc_filter_flag(mode, n, is_luma);
    const int32_t *S = filt ? af : a;
    int ang = INTRA_PRED_ANGLE[mode - 2];
    int vertical = mode >= 18;
    int inv = (mode >= 11 && mode <= 25) ? INTRA_INV_ANGLE[mode - 11] : 0;
    for (int y = 0; y < n; y++)
        for (int x = 0; x < n; x++) {
            int u = vertical ? x : y;
            int v = vertical ? y : x;
            int idx = ((v + 1) * ang) >> 5;
            int fact = ((v + 1) * ang) & 31;
            int k1 = u + idx + 1, k2 = fact ? u + idx + 2 : u + idx + 1;
            int a1, a2;
            if (k1 >= 0) a1 = vertical ? 2 * n + k1 : 2 * n - k1;
            else { int proj = (k1 * inv + 128) >> 8; a1 = vertical ? 2 * n - proj : 2 * n + proj; }
            if (k2 >= 0) a2 = vertical ? 2 * n + k2 : 2 * n - k2;
            else { int proj = (k2 * inv + 128) >> 8; a2 = vertical ? 2 * n - proj : 2 * n + proj; }
            out[y * n + x] = ((32 - fact) * S[a1] + fact * S[a2] + 16) >> 5;
        }
    if (is_luma && n < 32) {
        if (mode == 10) {
            for (int x = 0; x < n; x++) {
                int32_t v = a[2 * n - 1] + ((top[x] - corner) >> 1);
                out[x] = v < 0 ? 0 : v > 255 ? 255 : v;
            }
        } else if (mode == 26) {
            for (int y = 0; y < n; y++) {
                int32_t v = top[0] + ((a[2 * n - 1 - y] - corner) >> 1);
                out[y * n] = v < 0 ? 0 : v > 255 ? 255 : v;
            }
        }
    }
}

/* ---- dequant (8.6.3, flat lists) + inverse transform (8.6.4) ---- */
static const int16_t *rc_mat(int n, int dst) {
    if (n == 4) return dst ? &DST4[0][0] : &DCT4[0][0];
    if (n == 8) return &DCT8[0][0];
    if (n == 16) return &DCT16[0][0];
    return &DCT32[0][0];
}

static void rc_dequant(const int32_t *lev, int log2, int qp, int32_t *out) {
    int n = 1 << log2;
    int per = qp / 6, rem = qp % 6;
    int bd_shift = 8 + log2 - 5;
    int scale = (int)DEQUANT_SCALES[rem] * 16;
    int sh = bd_shift - per;
    for (int i = 0; i < n * n; i++) {
        int64_t x = (int64_t)lev[i] * scale;
        int64_t d = sh > 0 ? (x + (1LL << (sh - 1))) >> sh : x << (-sh);
        out[i] = d < -32768 ? -32768 : d > 32767 ? 32767 : (int32_t)d;
    }
}

static void rc_inv_transform(const int32_t *coef, int log2, int dst, int32_t *out) {
    int n = 1 << log2;
    const int16_t *M = rc_mat(n, dst);
    int32_t tmp[1024];
    for (int i = 0; i < n; i++)
        for (int j = 0; j < n; j++) {
            int64_t acc = 0;
            for (int k = 0; k < n; k++)
                acc += (int64_t)M[k * n + i] * coef[k * n + j];
            acc = (acc + 64) >> 7;
            tmp[i * n + j] = acc < -32768 ? -32768 : acc > 32767 ? 32767 : (int32_t)acc;
        }
    for (int i = 0; i < n; i++)
        for (int j = 0; j < n; j++) {
            int64_t acc = 0;
            for (int k = 0; k < n; k++)
                acc += (int64_t)tmp[i * n + k] * M[k * n + j];
            acc = (acc + 2048) >> 12;  /* bdShift = 20 - 8 */
            out[i * n + j] = acc < -32768 ? -32768 : acc > 32767 ? 32767 : (int32_t)acc;
        }
}

/* residual -> pixel-domain block: regular or transform-skip (8.6.4.2) */
static void rc_resid(GP *g, const int32_t *lev, int log2, int qp, int dst,
                     int tsf, int32_t *out) {
    int n = 1 << log2;
    if (!tsf) {
        int32_t deq[1024];
        rc_dequant(lev, log2, qp, deq);
        rc_inv_transform(deq, log2, dst, out);
        return;
    }
    int32_t deq[16];
    rc_dequant(lev, log2, qp, deq);
    for (int i = 0; i < n * n; i++) {
        int64_t r = (int64_t)deq[i] << 7;  /* tsShift = 5 + log2 (log2 == 2) */
        int64_t v = (r + 2048) >> 12;      /* bdShift = 20 - 8 */
        out[i] = v < -32768 ? -32768 : v > 32767 ? 32767 : (int32_t)v;
    }
}

/* intra luma TU (generic_intra._luma_unit) */
static void rc_luma_tu_intra(GP *g, int x0, int y0, int log2, int mode, int cbf) {
    RC *rc = g->rc;
    int n = 1 << log2;
    rc_mark_edges(g, x0, y0, n);
    int32_t pred[1024];
    rc_predict(g, rc->y, g->w, g->h, x0, y0, log2, 1, mode, 0, pred);
    int32_t res[1024];
    int have = 0;
    if (cbf) {
        int32_t lev[1024]; int tsf = 0;
        gp_residual_into(g, log2, 0, resid_scan_intra(mode, log2, 0), lev, &tsf);
        rc_resid(g, lev, log2, rc->qp_y, log2 == 2, tsf, res);
        have = 1;
    }
    for (int r = 0; r < n; r++)
        for (int c = 0; c < n; c++) {
            int32_t v = pred[r * n + c] + (have ? res[r * n + c] : 0);
            rc->y[(long)(y0 + r) * g->w + x0 + c] = v < 0 ? 0 : v > 255 ? 255 : v;
        }
}

/* intra chroma pair (generic_intra._chroma_unit); x0/y0 luma coords */
static void rc_chroma_unit_intra(GP *g, int x0, int y0, int log2c, int cmode,
                                 int cbf_cb, int cbf_cr) {
    RC *rc = g->rc;
    int xc = x0 >> 1, yc = y0 >> 1, n = 1 << log2c;
    int scan = resid_scan_intra(cmode, log2c, 1);
    int32_t *planes[2] = {rc->u, rc->v};
    int cbfs[2] = {cbf_cb, cbf_cr};
    int qps[2] = {rc->qp_cb, rc->qp_cr};
    for (int p = 0; p < 2; p++) {
        int32_t pred[1024], res[1024];
        rc_predict(g, planes[p], rc->w2, rc->h2, xc, yc, log2c, 0, cmode, 1, pred);
        int have = 0;
        if (cbfs[p]) {
            int32_t lev[1024]; int tsf = 0;
            gp_residual_into(g, log2c, p + 1, scan, lev, &tsf);
            rc_resid(g, lev, log2c, qps[p], 0, tsf, res);
            have = 1;
        }
        for (int r = 0; r < n; r++)
            for (int c = 0; c < n; c++) {
                int32_t v = pred[r * n + c] + (have ? res[r * n + c] : 0);
                planes[p][(long)(yc + r) * rc->w2 + xc + c] = v < 0 ? 0 : v > 255 ? 255 : v;
            }
    }
}

/* inter luma residual add (generic_inter._inter_tt leaf) */
static void rc_add_luma_resid(GP *g, int x0, int y0, int log2) {
    RC *rc = g->rc;
    int n = 1 << log2;
    int32_t lev[1024], res[1024];
    int tsf = 0;
    gp_residual_into(g, log2, 0, 0, lev, &tsf);
    rc_resid(g, lev, log2, rc->qp_y, 0, tsf, res);
    for (int r = 0; r < n; r++)
        for (int c = 0; c < n; c++) {
            long o = (long)(y0 + r) * g->w + x0 + c;
            int32_t v = rc->y[o] + res[r * n + c];
            rc->y[o] = v < 0 ? 0 : v > 255 ? 255 : v;
        }
    for (int yy = y0 >> 2; yy < (y0 + n) >> 2; yy++)
        for (int xx = x0 >> 2; xx < (x0 + n) >> 2; xx++)
            rc->cbf4[(long)yy * g->w4 + xx] = 1;
}

static void rc_add_chroma_resid(GP *g, int x0, int y0, int log2c,
                                int cbf_cb, int cbf_cr) {
    RC *rc = g->rc;
    int xc = x0 >> 1, yc = y0 >> 1, n = 1 << log2c;
    int32_t *planes[2] = {rc->u, rc->v};
    int cbfs[2] = {cbf_cb, cbf_cr};
    int qps[2] = {rc->qp_cb, rc->qp_cr};
    for (int p = 0; p < 2; p++) {
        if (!cbfs[p]) continue;
        int32_t lev[1024], res[1024];
        int tsf = 0;
        gp_residual_into(g, log2c, p + 1, 0, lev, &tsf);
        rc_resid(g, lev, log2c, qps[p], 0, tsf, res);
        for (int r = 0; r < n; r++)
            for (int c = 0; c < n; c++) {
                long o = (long)(yc + r) * rc->w2 + xc + c;
                int32_t v = planes[p][o] + res[r * n + c];
                planes[p][o] = v < 0 ? 0 : v > 255 ? 255 : v;
            }
    }
}

/* ---- motion compensation (8.5.4.2; generic_inter._mc_np) ---- */
/* wt: NULL or (w, o, denom); raw14 leaves the 14-bit domain value */
static void rc_mc(const int32_t *ref, int W, int H, int x0, int y0,
                  int w, int h, int mvx, int mvy, int luma, int raw14,
                  const int *wt, int32_t *out) {
    int ix, iy, fx, fy, reach, ntap;
    const int8_t *th, *tv;
    if (luma) {
        ix = x0 + (mvx >> 2); iy = y0 + (mvy >> 2);
        fx = mvx & 3; fy = mvy & 3;
        th = LUMA_FILTERS[fx]; tv = LUMA_FILTERS[fy];
        reach = 3; ntap = 8;
    } else {
        ix = x0 + (mvx >> 3); iy = y0 + (mvy >> 3);
        fx = mvx & 7; fy = mvy & 7;
        th = CHROMA_FILTERS[fx]; tv = CHROMA_FILTERS[fy];
        reach = 1; ntap = 4;
    }
    int inside = ix - reach >= 0 && iy - reach >= 0
        && ix - reach + w + ntap - 1 <= W && iy - reach + h + ntap - 1 <= H;
    if (inside && fx == 0 && fy == 0 && !wt) {
        if (!raw14) {
            /* integer position, plain uni-pred: straight copy */
            for (int r = 0; r < h; r++)
                memcpy(out + r * w, ref + (long)(iy + r) * W + ix,
                       sizeof(int32_t) * w);
        } else {
            /* integer position into the 14-bit bi-pred domain: both
               identity taps contribute x64, then >>6 — net <<6 */
            for (int r = 0; r < h; r++) {
                const int32_t *row = ref + (long)(iy + r) * W + ix;
                int32_t *dst = out + r * w;
                for (int c = 0; c < w; c++) dst[c] = row[c] << 6;
            }
        }
        return;
    }
    if (inside && fy == 0 && !wt) {
        /* horizontal-only: identity vertical taps cancel the >>6 */
        for (int r = 0; r < h; r++) {
            const int32_t *row = ref + (long)(iy + r) * W + ix - reach;
            int32_t *dst = out + r * w;
            for (int c = 0; c < w; c++) {
                int32_t acc = 0;
                for (int k = 0; k < ntap; k++) acc += th[k] * row[c + k];
                if (raw14) dst[c] = acc;
                else {
                    int v = (acc + 32) >> 6;
                    dst[c] = v < 0 ? 0 : v > 255 ? 255 : v;
                }
            }
        }
        return;
    }
    if (inside && fx == 0 && !wt) {
        /* vertical-only on integer columns */
        for (int r = 0; r < h; r++) {
            const int32_t *col0 = ref + (long)(iy - reach + r) * W + ix;
            int32_t *dst = out + r * w;
            for (int c = 0; c < w; c++) {
                int32_t acc = 0;
                for (int k = 0; k < ntap; k++)
                    acc += tv[k] * col0[(long)k * W + c];
                if (raw14) dst[c] = acc;
                else {
                    int v = (acc + 32) >> 6;
                    dst[c] = v < 0 ? 0 : v > 255 ? 255 : v;
                }
            }
        }
        return;
    }
    int32_t tmp[(64 + 7) * 64];
    if (inside) {
        /* fully interior window: no per-sample clamps (vectorizable) */
        for (int r = 0; r < h + ntap - 1; r++) {
            const int32_t *row = ref + (long)(iy - reach + r) * W + ix - reach;
            int32_t *dst = tmp + r * w;
            for (int c = 0; c < w; c++) {
                int32_t acc = 0;
                for (int k = 0; k < ntap; k++) acc += th[k] * row[c + k];
                dst[c] = acc;
            }
        }
    } else {
        for (int r = 0; r < h + ntap - 1; r++) {
            int yy = iy - reach + r;
            yy = yy < 0 ? 0 : yy >= H ? H - 1 : yy;
            const int32_t *row = ref + (long)yy * W;
            for (int c = 0; c < w; c++) {
                int32_t acc = 0;
                for (int k = 0; k < ntap; k++) {
                    int xx = ix - reach + c + k;
                    xx = xx < 0 ? 0 : xx >= W ? W - 1 : xx;
                    acc += th[k] * row[xx];
                }
                tmp[r * w + c] = acc;
            }
        }
    }
    if (wt) {
        int log2wd = wt[2] + 6;
        for (int r = 0; r < h; r++)
            for (int c = 0; c < w; c++) {
                int64_t acc = 0;
                for (int k = 0; k < ntap; k++)
                    acc += (int64_t)tv[k] * tmp[(r + k) * w + c];
                acc >>= 6;  /* 14-bit intermediate domain */
                int64_t v = ((acc * wt[0] + (1LL << (log2wd - 1))) >> log2wd)
                            + wt[1];
                out[r * w + c] = v < 0 ? 0 : v > 255 ? 255 : (int32_t)v;
            }
        return;
    }
    /* int32 accumulation is exact here: |h-pass| <= 255*112 and the
       v-pass adds another x112 — well inside 31 bits */
    for (int r = 0; r < h; r++)
        for (int c = 0; c < w; c++) {
            int32_t acc = 0;
            for (int k = 0; k < ntap; k++)
                acc += tv[k] * tmp[(r + k) * w + c];
            acc >>= 6;  /* 14-bit intermediate domain */
            if (raw14) { out[r * w + c] = acc; continue; }
            int v = (acc + 32) >> 6;
            out[r * w + c] = v < 0 ? 0 : v > 255 ? 255 : v;
        }
}

/* ---- motion derivation (8.5.3.2) ---- */
#define REFPLANE(arr, i) ((const int32_t *)(intptr_t)(arr)[i])

typedef struct { int mvx, mvy, ridx; } PM;
typedef struct { int pf[2]; int mv[2][2]; int rp[2]; } BM;

static int pm_eq(PM a, PM b) {
    return a.mvx == b.mvx && a.mvy == b.mvy && a.ridx == b.ridx;
}

static int bm_eq(const BM *a, const BM *b) {
    return a->pf[0] == b->pf[0] && a->pf[1] == b->pf[1]
        && a->mv[0][0] == b->mv[0][0] && a->mv[0][1] == b->mv[0][1]
        && a->mv[1][0] == b->mv[1][0] && a->mv[1][1] == b->mv[1][1]
        && a->rp[0] == b->rp[0] && a->rp[1] == b->rp[1];
}

static int rc_nb_mv(GP *g, int x, int y, PM *out) {
    if (x < 0 || y < 0 || x >= g->w || y >= g->h) return 0;
    if (!rc_same_slice(g, x, y, 0)) return 0;
    RC *rc = g->rc;
    long c = ((long)(y >> 2)) * g->w4 + (x >> 2);
    if (!rc->inter4[c]) return 0;
    out->mvx = rc->mv4[c * 2]; out->mvy = rc->mv4[c * 2 + 1];
    out->ridx = rc->ref4[c];
    return 1;
}

static int rc_nb_full(GP *g, int x, int y, BM *out) {
    if (x < 0 || y < 0 || x >= g->w || y >= g->h) return 0;
    if (!rc_same_slice(g, x, y, 0)) return 0;
    RC *rc = g->rc;
    long c = ((long)(y >> 2)) * g->w4 + (x >> 2);
    if (!rc->inter4[c]) return 0;
    out->pf[0] = rc->pf4[c * 2]; out->pf[1] = rc->pf4[c * 2 + 1];
    for (int l = 0; l < 2; l++)
        for (int k = 0; k < 2; k++)
            out->mv[l][k] = rc->mv4l[c * 4 + l * 2 + k];
    out->rp[0] = rc->refpoc4l[c * 2]; out->rp[1] = rc->refpoc4l[c * 2 + 1];
    return 1;
}

/* temporal MV scaling (8.5.3.2.9), exact integers */
static void rc_scale_mv(int mvx, int mvy, int tb, int td, int *ox, int *oy) {
    tb = tb < -128 ? -128 : tb > 127 ? 127 : tb;
    td = td < -128 ? -128 : td > 127 ? 127 : td;
    int atd = td < 0 ? -td : td;
    int tx = (16384 + (atd >> 1)) / (atd > 1 ? atd : 1);
    if (td < 0) tx = -tx;
    long dsf = ((long)tb * tx + 32) >> 6;
    dsf = dsf < -4096 ? -4096 : dsf > 4095 ? 4095 : dsf;
    int v[2] = {mvx, mvy};
    int *o[2] = {ox, oy};
    for (int i = 0; i < 2; i++) {
        long prod = dsf * v[i];
        long ap = prod < 0 ? -prod : prod;
        long r = (prod < 0 ? -1 : 1) * ((ap + 127) >> 8);
        *o[i] = r < -32768 ? -32768 : r > 32767 ? 32767 : (int)r;
    }
}

static int rc_tmvp_probe(GP *g, int x, int y, int *mvx, int *mvy, int *crp) {
    if (x >= g->w || y >= g->h) return 0;
    RC *rc = g->rc;
    int xg = (x >> 4) << 4, yg = (y >> 4) << 4;
    long c = ((long)(yg >> 2)) * g->w4 + (xg >> 2);
    if (!rc->col_inter4[c]) return 0;
    *mvx = rc->col_mv4[c * 2]; *mvy = rc->col_mv4[c * 2 + 1];
    *crp = rc->col_refpoc4[c];
    return 1;
}

/* temporal candidate scaled to target_poc (8.5.3.2.8) */
static int rc_tmvp(GP *g, int x0, int y0, int nw, int nh, int target_poc,
                   int *ox, int *oy) {
    RC *rc = g->rc;
    if (!rc->has_col) return 0;
    int mvx = 0, mvy = 0, crp = 0, got = 0;
    if (((y0 + nh) >> g->cl) == (y0 >> g->cl))
        got = rc_tmvp_probe(g, x0 + nw, y0 + nh, &mvx, &mvy, &crp);
    if (!got) got = rc_tmvp_probe(g, x0 + (nw >> 1), y0 + (nh >> 1), &mvx, &mvy, &crp);
    if (!got) return 0;
    int tb = rc->cur_poc - target_poc;
    int td = rc->col_poc - crp;
    if (tb == td) { *ox = mvx; *oy = mvy; return 1; }
    rc_scale_mv(mvx, mvy, tb, td, ox, oy);
    return 1;
}

/* part codes: 0 2Nx2N, 1 2NxN, 2 Nx2N, 3 2NxnU, 4 2NxnD, 5 nLx2N, 6 nRx2N */
#define PART_HORIZ(p) ((p) == 1 || (p) == 3 || (p) == 4)
#define PART_VERT(p)  ((p) == 2 || (p) == 5 || (p) == 6)

/* P merge list (8.5.3.2.3 pruned spatial + TMVP + zero cands) */
static void rc_merge_list_p(GP *g, int x0, int y0, int nw, int nh,
                            int part, int pi, PM *list) {
    RC *rc = g->rc;
    PM a1, b1, b0, a0;
    int ha1 = rc_nb_mv(g, x0 - 1, y0 + nh - 1, &a1);
    int hb1 = rc_nb_mv(g, x0 + nw - 1, y0 - 1, &b1);
    int hb0 = rc_nb_mv(g, x0 + nw, y0 - 1, &b0);
    int ha0 = rc_nb_mv(g, x0 - 1, y0 + nh, &a0);
    if (pi == 1 && PART_VERT(part)) ha1 = 0;
    if (pi == 1 && PART_HORIZ(part)) hb1 = 0;
    int nc = 0;
    if (ha1) list[nc++] = a1;
    if (hb1 && !(ha1 && pm_eq(b1, a1))) list[nc++] = b1;
    if (hb0 && !(hb1 && pm_eq(b0, b1))) list[nc++] = b0;
    if (ha0 && !(ha1 && pm_eq(a0, a1))) list[nc++] = a0;
    if (nc < 4) {
        PM b2;
        int hb2 = rc_nb_mv(g, x0 - 1, y0 - 1, &b2);
        if (hb2 && !(ha1 && pm_eq(b2, a1)) && !(hb1 && pm_eq(b2, b1)))
            list[nc++] = b2;
    }
    int tx_, ty_;
    if (rc_tmvp(g, x0, y0, nw, nh, rc->ref0_poc[0], &tx_, &ty_)) {
        list[nc].mvx = tx_; list[nc].mvy = ty_; list[nc].ridx = 0; nc++;
    }
    int zr = 0;
    while (nc < g->max_merge) {
        list[nc].mvx = 0; list[nc].mvy = 0;
        list[nc].ridx = zr < g->nref0 - 1 ? zr : g->nref0 - 1;
        nc++; zr++;
    }
}

/* P AMVP (8.5.3.2.7): same-ref pass, scaled pass, B->A promotion */
static void rc_amvp_p(GP *g, int x0, int y0, int nw, int nh, int ridx,
                      int mvp[2][2]) {
    RC *rc = g->rc;
    int tpoc = rc->ref0_poc[ridx];
    int apos[2][2] = {{x0 - 1, y0 + nh}, {x0 - 1, y0 + nh - 1}};
    int bpos[3][2] = {{x0 + nw, y0 - 1}, {x0 + nw - 1, y0 - 1}, {x0 - 1, y0 - 1}};
    int ha = 0, hb = 0;
    int av[2] = {0, 0}, bv[2] = {0, 0};
    /* same-ref passes */
    for (int p = 0; p < 2 && !ha; p++) {
        PM nb;
        if (rc_nb_mv(g, apos[p][0], apos[p][1], &nb)
                && rc->ref0_poc[nb.ridx] == tpoc) {
            av[0] = nb.mvx; av[1] = nb.mvy; ha = 1;
        }
    }
    for (int p = 0; p < 3 && !hb; p++) {
        PM nb;
        if (rc_nb_mv(g, bpos[p][0], bpos[p][1], &nb)
                && rc->ref0_poc[nb.ridx] == tpoc) {
            bv[0] = nb.mvx; bv[1] = nb.mvy; hb = 1;
        }
    }
    int is_scaled = 0;
    for (int p = 0; p < 2; p++) {
        PM nb;
        if (rc_nb_mv(g, apos[p][0], apos[p][1], &nb)) { is_scaled = 1; break; }
    }
    if (!ha && is_scaled) {
        for (int p = 0; p < 2 && !ha; p++) {
            PM nb;
            if (rc_nb_mv(g, apos[p][0], apos[p][1], &nb)) {
                if (rc->ref0_poc[nb.ridx] == tpoc) { av[0] = nb.mvx; av[1] = nb.mvy; }
                else rc_scale_mv(nb.mvx, nb.mvy, rc->cur_poc - tpoc,
                                 rc->cur_poc - rc->ref0_poc[nb.ridx], &av[0], &av[1]);
                ha = 1;
            }
        }
    }
    if (!is_scaled) {
        if (!ha && hb) { av[0] = bv[0]; av[1] = bv[1]; ha = 1; }
        hb = 0;
        for (int p = 0; p < 3 && !hb; p++) {
            PM nb;
            if (rc_nb_mv(g, bpos[p][0], bpos[p][1], &nb)) {
                if (rc->ref0_poc[nb.ridx] == tpoc) { bv[0] = nb.mvx; bv[1] = nb.mvy; }
                else rc_scale_mv(nb.mvx, nb.mvy, rc->cur_poc - tpoc,
                                 rc->cur_poc - rc->ref0_poc[nb.ridx], &bv[0], &bv[1]);
                hb = 1;
            }
        }
    }
    int nc = 0;
    if (ha) { mvp[nc][0] = av[0]; mvp[nc][1] = av[1]; nc++; }
    if (hb && !(ha && bv[0] == av[0] && bv[1] == av[1])) {
        mvp[nc][0] = bv[0]; mvp[nc][1] = bv[1]; nc++;
    }
    if (nc < 2) {
        int tx_, ty_;
        if (rc_tmvp(g, x0, y0, nw, nh, tpoc, &tx_, &ty_)) {
            mvp[nc][0] = tx_; mvp[nc][1] = ty_; nc++;
        }
    }
    while (nc < 2) { mvp[nc][0] = 0; mvp[nc][1] = 0; nc++; }
}

/* P commit (generic_inter._commit_inter_rect): MC + state stores */
static void rc_commit_p(GP *g, int x0, int y0, int nw, int nh, PM m, int skip) {
    RC *rc = g->rc;
    const int32_t *ry = REFPLANE(rc->ref0, m.ridx * 3 + 0);
    const int32_t *ru = REFPLANE(rc->ref0, m.ridx * 3 + 1);
    const int32_t *rv = REFPLANE(rc->ref0, m.ridx * 3 + 2);
    int rpoc = rc->ref0_poc[m.ridx];
    int wl[3], wcb[3], wcr[3];
    int has_w = rc->wt != NULL;
    if (has_w) {
        const int32_t *e = rc->wt + 2 + m.ridx * 6;
        wl[0] = e[0]; wl[1] = e[1]; wl[2] = rc->wt[0];
        wcb[0] = e[2]; wcb[1] = e[3]; wcb[2] = rc->wt[1];
        wcr[0] = e[4]; wcr[1] = e[5]; wcr[2] = rc->wt[1];
    }
    int32_t blk[64 * 64];
    rc_mc(ry, g->w, g->h, x0, y0, nw, nh, m.mvx, m.mvy, 1, 0,
          has_w ? wl : NULL, blk);
    for (int r = 0; r < nh; r++)
        memcpy(rc->y + (long)(y0 + r) * g->w + x0, blk + r * nw,
               sizeof(int32_t) * nw);
    int xc = x0 >> 1, yc = y0 >> 1, wc = nw >> 1, hc = nh >> 1;
    rc_mc(ru, rc->w2, rc->h2, xc, yc, wc, hc, m.mvx, m.mvy, 0, 0,
          has_w ? wcb : NULL, blk);
    for (int r = 0; r < hc; r++)
        memcpy(rc->u + (long)(yc + r) * rc->w2 + xc, blk + r * wc,
               sizeof(int32_t) * wc);
    rc_mc(rv, rc->w2, rc->h2, xc, yc, wc, hc, m.mvx, m.mvy, 0, 0,
          has_w ? wcr : NULL, blk);
    for (int r = 0; r < hc; r++)
        memcpy(rc->v + (long)(yc + r) * rc->w2 + xc, blk + r * wc,
               sizeof(int32_t) * wc);
    for (int yy = y0 >> 2; yy < (y0 + nh) >> 2; yy++)
        for (int xx = x0 >> 2; xx < (x0 + nw) >> 2; xx++) {
            long c = (long)yy * g->w4 + xx;
            rc->inter4[c] = 1;
            rc->mv4[c * 2] = m.mvx; rc->mv4[c * 2 + 1] = m.mvy;
            rc->ref4[c] = m.ridx;
            rc->refpoc4[c] = rpoc;
            g->skip4[c] = skip;
            g->mode4[c] = 1;
        }
}

/* ---- B-slice motion (generic_b.py) ---- */

/* B merge list (full-motion spatial + TMVP + combined-bi + zeros) */
static int rc_tmvp_full(GP *g, int x0, int y0, int nw, int nh, BM *out) {
    RC *rc = g->rc;
    int t0x, t0y;
    if (!rc_tmvp(g, x0, y0, nw, nh, rc->ref0_poc[0], &t0x, &t0y)) return 0;
    if (!rc->has_col || g->nref1 == 0) return 0;
    int mvx = 0, mvy = 0, crp = 0, got = 0;
    if (((y0 + nh) >> g->cl) == (y0 >> g->cl))
        got = rc_tmvp_probe(g, x0 + nw, y0 + nh, &mvx, &mvy, &crp);
    if (!got) got = rc_tmvp_probe(g, x0 + (nw >> 1), y0 + (nh >> 1), &mvx, &mvy, &crp);
    if (!got) return 0;
    int tb1 = rc->cur_poc - rc->ref1_poc[0];
    int td = rc->col_poc - crp;
    int t1x = mvx, t1y = mvy;
    if (tb1 != td) rc_scale_mv(mvx, mvy, tb1, td, &t1x, &t1y);
    out->pf[0] = 1; out->pf[1] = 1;
    out->mv[0][0] = t0x; out->mv[0][1] = t0y;
    out->mv[1][0] = t1x; out->mv[1][1] = t1y;
    out->rp[0] = rc->ref0_poc[0]; out->rp[1] = rc->ref1_poc[0];
    return 1;
}

static void rc_merge_list_b(GP *g, int x0, int y0, int nw, int nh,
                            int part, int pi, BM *list) {
    RC *rc = g->rc;
    BM a1, b1, b0, a0;
    int ha1 = rc_nb_full(g, x0 - 1, y0 + nh - 1, &a1);
    int hb1 = rc_nb_full(g, x0 + nw - 1, y0 - 1, &b1);
    int hb0 = rc_nb_full(g, x0 + nw, y0 - 1, &b0);
    int ha0 = rc_nb_full(g, x0 - 1, y0 + nh, &a0);
    if (pi == 1 && PART_VERT(part)) ha1 = 0;
    if (pi == 1 && PART_HORIZ(part)) hb1 = 0;
    int nc = 0;
    if (ha1) list[nc++] = a1;
    if (hb1 && !(ha1 && bm_eq(&b1, &a1))) list[nc++] = b1;
    if (hb0 && !(hb1 && bm_eq(&b0, &b1))) list[nc++] = b0;
    if (ha0 && !(ha1 && bm_eq(&a0, &a1))) list[nc++] = a0;
    if (nc < 4) {
        BM b2;
        int hb2 = rc_nb_full(g, x0 - 1, y0 - 1, &b2);
        if (hb2 && !(ha1 && bm_eq(&b2, &a1)) && !(hb1 && bm_eq(&b2, &b1)))
            list[nc++] = b2;
    }
    BM t;
    if (rc_tmvp_full(g, x0, y0, nw, nh, &t)) list[nc++] = t;
    /* combined bi-predictive candidates (8.5.3.2.4) */
    static const int order[12][2] = {{0,1},{1,0},{0,2},{2,0},{1,2},{2,1},
                                     {0,3},{3,0},{1,3},{3,1},{2,3},{3,2}};
    BM base[8];
    int nbase = nc;
    memcpy(base, list, sizeof(BM) * (size_t)nc);
    for (int oi = 0; oi < 12; oi++) {
        if (nc >= g->max_merge) break;
        int i = order[oi][0], j = order[oi][1];
        if (i >= nbase || j >= nbase) continue;
        if (base[i].pf[0] && base[j].pf[1]) {
            BM comb;
            comb.pf[0] = 1; comb.pf[1] = 1;
            comb.mv[0][0] = base[i].mv[0][0]; comb.mv[0][1] = base[i].mv[0][1];
            comb.mv[1][0] = base[j].mv[1][0]; comb.mv[1][1] = base[j].mv[1][1];
            comb.rp[0] = base[i].rp[0]; comb.rp[1] = base[j].rp[1];
            if (!(comb.rp[0] == comb.rp[1]
                  && comb.mv[0][0] == comb.mv[1][0]
                  && comb.mv[0][1] == comb.mv[1][1]))
                list[nc++] = comb;
        }
    }
    int zr = 0;
    while (nc < g->max_merge) {
        BM z;
        z.pf[0] = 1; z.pf[1] = 1;
        z.mv[0][0] = z.mv[0][1] = z.mv[1][0] = z.mv[1][1] = 0;
        z.rp[0] = rc->ref0_poc[zr < g->nref0 - 1 ? zr : g->nref0 - 1];
        z.rp[1] = rc->ref1_poc[zr < g->nref1 - 1 ? zr : g->nref1 - 1];
        list[nc++] = z;
        zr++;
    }
}

/* per-list B AMVP (generic_b._amvp_rect_list) */
static void rc_amvp_b_list(GP *g, int x0, int y0, int nw, int nh,
                           int lx, int ridx, int mvp[2][2]) {
    RC *rc = g->rc;
    int tpoc = (lx == 0 ? rc->ref0_poc : rc->ref1_poc)[ridx];
    int apos[2][2] = {{x0 - 1, y0 + nh}, {x0 - 1, y0 + nh - 1}};
    int bpos[3][2] = {{x0 + nw, y0 - 1}, {x0 + nw - 1, y0 - 1}, {x0 - 1, y0 - 1}};

    /* cand_at: same-list-then-other same-poc pass; optional scaled pass */
    int ha = 0, hb = 0;
    int av[2] = {0, 0}, bv[2] = {0, 0};

#define CAND_AT(px, py, allow_scale, ok, vx, vy) do { \
    BM nb; ok = 0; \
    if (rc_nb_full(g, (px), (py), &nb)) { \
        for (int l = 0; l < 2 && !ok; l++) { \
            int ll = l == 0 ? lx : 1 - lx; \
            if (nb.pf[ll] && nb.rp[ll] == tpoc) { \
                vx = nb.mv[ll][0]; vy = nb.mv[ll][1]; ok = 1; \
            } \
        } \
        if (!ok && (allow_scale)) { \
            for (int l = 0; l < 2 && !ok; l++) { \
                int ll = l == 0 ? lx : 1 - lx; \
                if (nb.pf[ll]) { \
                    rc_scale_mv(nb.mv[ll][0], nb.mv[ll][1], \
                                rc->cur_poc - tpoc, rc->cur_poc - nb.rp[ll], \
                                &vx, &vy); \
                    ok = 1; \
                } \
            } \
        } \
    } \
} while (0)

    int is_scaled = 0;
    for (int p = 0; p < 2; p++) {
        BM nb;
        if (rc_nb_full(g, apos[p][0], apos[p][1], &nb)) { is_scaled = 1; break; }
    }
    for (int p = 0; p < 2 && !ha; p++)
        CAND_AT(apos[p][0], apos[p][1], 0, ha, av[0], av[1]);
    if (!ha && is_scaled)
        for (int p = 0; p < 2 && !ha; p++)
            CAND_AT(apos[p][0], apos[p][1], 1, ha, av[0], av[1]);
    for (int p = 0; p < 3 && !hb; p++)
        CAND_AT(bpos[p][0], bpos[p][1], 0, hb, bv[0], bv[1]);
    if (!is_scaled) {
        if (!ha && hb) { av[0] = bv[0]; av[1] = bv[1]; ha = 1; }
        hb = 0;
        for (int p = 0; p < 3 && !hb; p++)
            CAND_AT(bpos[p][0], bpos[p][1], 1, hb, bv[0], bv[1]);
    }
#undef CAND_AT
    int nc = 0;
    if (ha) { mvp[nc][0] = av[0]; mvp[nc][1] = av[1]; nc++; }
    if (hb && !(ha && bv[0] == av[0] && bv[1] == av[1])) {
        mvp[nc][0] = bv[0]; mvp[nc][1] = bv[1]; nc++;
    }
    if (nc < 2 && rc->has_col) {
        int tx_, ty_;
        if (rc_tmvp(g, x0, y0, nw, nh, tpoc, &tx_, &ty_)) {
            mvp[nc][0] = tx_; mvp[nc][1] = ty_; nc++;
        }
    }
    while (nc < 2) { mvp[nc][0] = 0; mvp[nc][1] = 0; nc++; }
}

/* B commit (generic_b._commit_b): per-list MC, bi/weighted combine */
static void rc_commit_b(GP *g, int x0, int y0, int nw, int nh,
                        const BM *m, int skip) {
    RC *rc = g->rc;
    int has_w = rc->wt != NULL;
    int raw14 = (m->pf[0] && m->pf[1]) || has_w;
    int ridxs[2] = {0, 0};
    int32_t py_[2][64 * 64], pu_[2][32 * 32], pv_[2][32 * 32];
    for (int l = 0; l < 2; l++) {
        if (!m->pf[l]) continue;
        const int64_t *refs = l == 0 ? rc->ref0 : rc->ref1;
        const int32_t *pocs = l == 0 ? rc->ref0_poc : rc->ref1_poc;
        int nrefs = l == 0 ? g->nref0 : g->nref1;
        int ridx = 0;
        for (int k = 0; k < nrefs; k++)
            if (pocs[k] == m->rp[l]) { ridx = k; break; }
        ridxs[l] = ridx;
        int mvx = m->mv[l][0], mvy = m->mv[l][1];
        rc_mc(REFPLANE(refs, ridx * 3 + 0), g->w, g->h, x0, y0, nw, nh,
              mvx, mvy, 1, raw14, NULL, py_[l]);
        rc_mc(REFPLANE(refs, ridx * 3 + 1), rc->w2, rc->h2, x0 >> 1, y0 >> 1,
              nw >> 1, nh >> 1, mvx, mvy, 0, raw14, NULL, pu_[l]);
        rc_mc(REFPLANE(refs, ridx * 3 + 2), rc->w2, rc->h2, x0 >> 1, y0 >> 1,
              nw >> 1, nh >> 1, mvx, mvy, 0, raw14, NULL, pv_[l]);
    }
    int wc2 = nw >> 1, hc2 = nh >> 1;
    /* weight entries: wt[2 + r*6 ..] for l0, wt[2 + nref0*6 + r*6 ..] l1 */
    const int32_t *w0e = NULL, *w1e = NULL;
    int ld = 0, cd = 0;
    if (has_w) {
        ld = rc->wt[0]; cd = rc->wt[1];
        w0e = rc->wt + 2 + ridxs[0] * 6;
        w1e = rc->wt + 2 + g->nref0 * 6 + ridxs[1] * 6;
    }
    for (int comp = 0; comp < 3; comp++) {
        int W = comp == 0 ? g->w : rc->w2;
        int bw = comp == 0 ? nw : wc2, bh = comp == 0 ? nh : hc2;
        int bx = comp == 0 ? x0 : x0 >> 1, by = comp == 0 ? y0 : y0 >> 1;
        int32_t *dst = comp == 0 ? rc->y : comp == 1 ? rc->u : rc->v;
        const int32_t *p0 = comp == 0 ? py_[0] : comp == 1 ? pu_[0] : pv_[0];
        const int32_t *p1 = comp == 0 ? py_[1] : comp == 1 ? pu_[1] : pv_[1];
        int denom = comp == 0 ? ld : cd;
        /* per-component weight (w, o) per list */
        int wA = 0, oA = 0, wB = 0, oB = 0;
        if (has_w) {
            int off = comp == 0 ? 0 : comp == 1 ? 2 : 4;
            wA = w0e[off]; oA = w0e[off + 1];
            wB = w1e[off]; oB = w1e[off + 1];
        }
        for (int r = 0; r < bh; r++)
            for (int c = 0; c < bw; c++) {
                long o = (long)(by + r) * W + bx + c;
                int64_t v;
                if (m->pf[0] && m->pf[1]) {
                    int64_t A = p0[r * bw + c], B = p1[r * bw + c];
                    if (!has_w) v = (A + B + 64) >> 7;
                    else {
                        int log2wd = denom + 6;
                        v = (A * wA + B * wB
                             + ((int64_t)(oA + oB + 1) << log2wd)) >> (log2wd + 1);
                    }
                } else {
                    int l = m->pf[0] ? 0 : 1;
                    const int32_t *P = l == 0 ? p0 : p1;
                    if (!has_w) v = P[r * bw + c];  /* already clipped (raw14 off) */
                    else {
                        int log2wd = denom + 6;
                        int wU = l == 0 ? wA : wB, oU = l == 0 ? oA : oB;
                        v = (((int64_t)P[r * bw + c] * wU
                              + (1LL << (log2wd - 1))) >> log2wd) + oU;
                    }
                }
                if (raw14) v = v < 0 ? 0 : v > 255 ? 255 : v;
                dst[o] = (int32_t)v;
            }
    }
    for (int yy = y0 >> 2; yy < (y0 + nh) >> 2; yy++)
        for (int xx = x0 >> 2; xx < (x0 + nw) >> 2; xx++) {
            long c = (long)yy * g->w4 + xx;
            rc->inter4[c] = 1;
            rc->pf4[c * 2] = (uint8_t)m->pf[0];
            rc->pf4[c * 2 + 1] = (uint8_t)m->pf[1];
            for (int l = 0; l < 2; l++)
                for (int k = 0; k < 2; k++)
                    rc->mv4l[c * 4 + l * 2 + k] = m->mv[l][k];
            rc->refpoc4l[c * 2] = m->rp[0];
            rc->refpoc4l[c * 2 + 1] = m->rp[1];
            int l0 = m->pf[0] ? 0 : 1;
            rc->mv4[c * 2] = m->mv[l0][0]; rc->mv4[c * 2 + 1] = m->mv[l0][1];
            rc->refpoc4[c] = m->rp[l0];
            g->skip4[c] = skip;
            g->mode4[c] = 1;
        }
}

/* ---- transform tree (intra: 7.3.8.8 with IntraSplitFlag) ---- */
static void gp_tt_intra(GP *g, int x0, int y0, int log2, int depth,
                        int intra_split, const int *modes, int cmode,
                        int cbf_cb_p, int cbf_cr_p) {
    if (g->err) return;
    int max_depth = g->td_intra + (intra_split ? 1 : 0);
    int split;
    if (log2 <= g->max_tb && log2 > g->min_tb && depth < max_depth
            && !(intra_split && depth == 0))
        split = gp_bin(g, CTX_SPLIT_TRANSFORM_FLAG + 5 - log2);
    else
        split = (log2 > g->max_tb) || (intra_split && depth == 0);
    int cbf_cb = 0, cbf_cr = 0;
    if (log2 > 2) {
        if (cbf_cb_p) cbf_cb = gp_bin(g, CTX_CBF_CHROMA + depth);
        if (cbf_cr_p) cbf_cr = gp_bin(g, CTX_CBF_CHROMA + depth);
    } else { cbf_cb = cbf_cb_p; cbf_cr = cbf_cr_p; }
    if (split) {
        int hh = 1 << (log2 - 1);
        static const int zo[4][2] = {{0,0},{0,1},{1,0},{1,1}};
        for (int j = 0; j < 4; j++) {
            gp_tt_intra(g, x0 + zo[j][1] * hh, y0 + zo[j][0] * hh, log2 - 1,
                        depth + 1, intra_split, modes, cmode, cbf_cb, cbf_cr);
            if (log2 - 1 == 2 && j == 3) {
                /* chroma of four 4x4 luma TUs at the parent */
                if (g->rc) rc_chroma_unit_intra(g, x0, y0, 2, cmode, cbf_cb, cbf_cr);
                else {
                    int scan = resid_scan_intra(cmode, 2, 1);
                    if (cbf_cb) gp_residual(g, 2, 1, scan);
                    if (cbf_cr) gp_residual(g, 2, 2, scan);
                }
            }
            if (g->err) return;
        }
        return;
    }
    int cbf_luma = gp_bin(g, CTX_CBF_LUMA + (depth == 0 ? 1 : 0));
    int mode = modes[0];
    if (intra_split) {
        int j = ((y0 >> log2) & 1) * 2 + ((x0 >> log2) & 1);
        mode = modes[j];
    }
    int chroma_here = (log2 > 2) && (cbf_cb || cbf_cr);
    int last4 = (log2 == 2) && ((y0 >> 2) & 1) && ((x0 >> 2) & 1);
    if (cbf_luma || chroma_here || (last4 && (cbf_cb || cbf_cr)))
        gp_maybe_qp_delta(g);
    if (g->rc) rc_luma_tu_intra(g, x0, y0, log2, mode, cbf_luma);
    else if (cbf_luma)
        gp_residual(g, log2, 0, resid_scan_intra(mode, log2, 0));
    if (log2 > 2) {
        if (g->rc) rc_chroma_unit_intra(g, x0, y0, log2 - 1, cmode, cbf_cb, cbf_cr);
        else {
            int scan = resid_scan_intra(cmode, log2 - 1, 1);
            if (cbf_cb) gp_residual(g, log2 - 1, 1, scan);
            if (cbf_cr) gp_residual(g, log2 - 1, 2, scan);
        }
    }
}

/* ---- intra CU (shared by I slices and intra CUs in P/B) ---- */
static void gp_cu_intra(GP *g, int x0, int y0, int log2) {
    int n = 1 << log2;
    int nxn = 0;
    if (log2 == g->min_cb)
        nxn = gp_bin(g, CTX_PART_MODE) == 0;
    rc_mark_edges(g, x0, y0, n);
    if (g->pcm_min >= 0 && !nxn && log2 >= g->pcm_min && log2 <= g->pcm_max) {
        if (gp_term(g)) {
            gp_pcm(g, x0, y0, log2);
            for (int yy = y0 >> 2; yy < (y0 + n) >> 2; yy++)
                for (int xx = x0 >> 2; xx < (x0 + n) >> 2; xx++)
                    g->mode4[(long)yy * g->w4 + xx] = 1;
            return;
        }
    }
    int modes[4] = {1, 1, 1, 1};
    if (!nxn) {
        int m = gp_luma_mode(g, x0, y0);
        modes[0] = modes[1] = modes[2] = modes[3] = m;
        for (int yy = y0 >> 2; yy < (y0 + n) >> 2; yy++)
            for (int xx = x0 >> 2; xx < (x0 + n) >> 2; xx++)
                g->mode4[(long)yy * g->w4 + xx] = m;
    } else {
        int hh = n >> 1;
        int flags[4];
        for (int j = 0; j < 4; j++) flags[j] = gp_bin(g, CTX_PREV_INTRA_LUMA_PRED_FLAG);
        static const int zo[4][2] = {{0,0},{0,1},{1,0},{1,1}};
        for (int j = 0; j < 4; j++) {
            int px = x0 + zo[j][1] * hh, py = y0 + zo[j][0] * hh;
            int a, b;
            gp_cands(g, px, py, &a, &b);
            int m = gp_luma_mode_tail(g, a, b, flags[j]);
            modes[j] = m;
            for (int yy = py >> 2; yy < (py + hh) >> 2; yy++)
                for (int xx = px >> 2; xx < (px + hh) >> 2; xx++)
                    g->mode4[(long)yy * g->w4 + xx] = m;
        }
    }
    int cmode = gp_chroma_mode(g, modes[0]);
    gp_tt_intra(g, x0, y0, log2, 0, nxn, modes, cmode, 1, 1);
}

/* ---- inter transform tree (mirror generic_inter._inter_tt) ---- */
static void gp_tt_inter(GP *g, int x0, int y0, int log2, int depth,
                        int cbf_cb_p, int cbf_cr_p, int inter_split) {
    if (g->err) return;
    int isf = (inter_split && g->td_inter == 0) ? 1 : 0;
    int max_depth = g->td_inter + isf;
    int forced = (isf == 1 && depth == 0);
    int split;
    if (log2 <= g->max_tb && log2 > g->min_tb && depth < max_depth && !forced)
        split = gp_bin(g, CTX_SPLIT_TRANSFORM_FLAG + 5 - log2);
    else
        split = (log2 > g->max_tb) || forced;
    int cbf_cb = 0, cbf_cr = 0;
    if (log2 > 2) {
        if (cbf_cb_p) cbf_cb = gp_bin(g, CTX_CBF_CHROMA + depth);
        if (cbf_cr_p) cbf_cr = gp_bin(g, CTX_CBF_CHROMA + depth);
    } else { cbf_cb = cbf_cb_p; cbf_cr = cbf_cr_p; }
    if (split) {
        int hh = 1 << (log2 - 1);
        static const int zo[4][2] = {{0,0},{0,1},{1,0},{1,1}};
        for (int j = 0; j < 4; j++) {
            gp_tt_inter(g, x0 + zo[j][1] * hh, y0 + zo[j][0] * hh, log2 - 1,
                        depth + 1, cbf_cb, cbf_cr, inter_split);
            if (log2 - 1 == 2 && j == 3) {
                if (g->rc) rc_add_chroma_resid(g, x0, y0, 2, cbf_cb, cbf_cr);
                else {
                    if (cbf_cb) gp_residual(g, 2, 1, 0);
                    if (cbf_cr) gp_residual(g, 2, 2, 0);
                }
            }
            if (g->err) return;
        }
        return;
    }
    int cbf_luma;
    if (depth == 0 && !(cbf_cb || cbf_cr)) cbf_luma = 1;  /* inferred */
    else cbf_luma = gp_bin(g, CTX_CBF_LUMA + (depth == 0 ? 1 : 0));
    int last4 = (log2 == 2) && ((y0 >> 2) & 1) && ((x0 >> 2) & 1);
    if (cbf_luma || ((cbf_cb || cbf_cr) && log2 > 2) || (last4 && (cbf_cb || cbf_cr)))
        gp_maybe_qp_delta(g);
    rc_mark_edges(g, x0, y0, 1 << log2);
    if (cbf_luma) {
        if (g->rc) rc_add_luma_resid(g, x0, y0, log2);
        else gp_residual(g, log2, 0, 0);
    }
    if (log2 > 2) {
        if (g->rc) rc_add_chroma_resid(g, x0, y0, log2 - 1, cbf_cb, cbf_cr);
        else {
            if (cbf_cb) gp_residual(g, log2 - 1, 1, 0);
            if (cbf_cr) gp_residual(g, log2 - 1, 2, 0);
        }
    }
}

/* ---- inter PU prediction syntax (+ recon-mode motion derivation) ---- */
static void gp_pu_p(GP *g, int px, int py, int pw, int ph, PM *out) {
    /* P slice AMVP PU: ref_idx, mvd, mvp_flag */
    int ridx = gp_ref_idx(g, g->nref0);
    int mdx, mdy;
    gp_mvd(g, &mdx, &mdy);
    int use1 = gp_bin(g, CTX_MVP_FLAG);
    if (g->rc) {
        int mvp[2][2];
        rc_amvp_p(g, px, py, pw, ph, ridx, mvp);
        out->mvx = mvp[use1][0] + mdx;
        out->mvy = mvp[use1][1] + mdy;
        out->ridx = ridx;
    }
}

static void gp_pu_b(GP *g, int px, int py, int pw, int ph, int log2, BM *out) {
    int kinds;  /* 0 L0, 1 L1, 2 BI */
    if (pw + ph == 12) {
        kinds = gp_bin(g, CTX_INTER_PRED_IDC + 4) ? 1 : 0;
    } else {
        if (gp_bin(g, CTX_INTER_PRED_IDC + (g->cl - log2))) kinds = 2;
        else kinds = gp_bin(g, CTX_INTER_PRED_IDC + 4) ? 1 : 0;
    }
    memset(out, 0, sizeof *out);
    out->pf[0] = (kinds == 0 || kinds == 2);
    out->pf[1] = (kinds == 1 || kinds == 2);
    if (out->pf[0]) {
        int r0 = gp_ref_idx(g, g->nref0);
        int mdx, mdy;
        gp_mvd(g, &mdx, &mdy);
        int use1 = gp_bin(g, CTX_MVP_FLAG);
        if (g->rc) {
            int mvp[2][2];
            rc_amvp_b_list(g, px, py, pw, ph, 0, r0, mvp);
            out->mv[0][0] = mvp[use1][0] + mdx;
            out->mv[0][1] = mvp[use1][1] + mdy;
            out->rp[0] = g->rc->ref0_poc[r0];
        }
    }
    if (out->pf[1]) {
        int r1 = gp_ref_idx(g, g->nref1);
        int mdx = 0, mdy = 0;
        if (!(g->mvd_l1_zero && kinds == 2)) gp_mvd(g, &mdx, &mdy);
        int use1 = gp_bin(g, CTX_MVP_FLAG);
        if (g->rc) {
            int mvp[2][2];
            rc_amvp_b_list(g, px, py, pw, ph, 1, r1, mvp);
            out->mv[1][0] = mvp[use1][0] + mdx;
            out->mv[1][1] = mvp[use1][1] + mdy;
            out->rp[1] = g->rc->ref1_poc[r1];
        }
    }
}

/* ---- coding unit (P/B inter dispatch; mirrors generic_inter/_b) ---- */
static void gp_cu(GP *g, int x0, int y0, int log2) {
    int n = 1 << log2;
    if (g->slice_type == 2) { gp_cu_intra(g, x0, y0, log2); return; }
    int ctx = 0;
    if (x0 > 0 && gp_same_slice(g, x0 - 1, y0)
            && g->skip4[(long)(y0 >> 2) * g->w4 + ((x0 - 1) >> 2)]) ctx++;
    if (y0 > 0 && gp_same_slice(g, x0, y0 - 1)
            && g->skip4[(long)((y0 - 1) >> 2) * g->w4 + (x0 >> 2)]) ctx++;
    int skip = gp_bin(g, CTX_CU_SKIP_FLAG + ctx);
    for (int yy = y0 >> 2; yy < (y0 + n) >> 2; yy++)
        for (int xx = x0 >> 2; xx < (x0 + n) >> 2; xx++)
            g->skip4[(long)yy * g->w4 + xx] = skip;
    if (skip) {
        int idx = gp_merge_idx(g);
        if (g->rc) {
            if (g->slice_type == 0) {
                BM lst[8];
                rc_merge_list_b(g, x0, y0, n, n, 0, 0, lst);
                rc_commit_b(g, x0, y0, n, n, &lst[idx], 1);
            } else {
                PM lst[8];
                rc_merge_list_p(g, x0, y0, n, n, 0, 0, lst);
                rc_commit_p(g, x0, y0, n, n, lst[idx], 1);
            }
            rc_mark_edges(g, x0, y0, n);
        }
        for (int yy = y0 >> 2; yy < (y0 + n) >> 2; yy++)
            for (int xx = x0 >> 2; xx < (x0 + n) >> 2; xx++)
                g->mode4[(long)yy * g->w4 + xx] = 1;
        return;
    }
    if (gp_bin(g, CTX_PRED_MODE_FLAG)) {
        gp_cu_intra(g, x0, y0, log2);
        return;
    }
    /* inter CU: part_mode (9.3.3.7 incl. AMP suffix) */
    int amp_here = g->amp && log2 > g->min_cb;
    int part = 0;  /* 0 2Nx2N, 1 2NxN, 2 Nx2N, 3 2NxnU, 4 2NxnD, 5 nLx2N, 6 nRx2N */
    if (!gp_bin(g, CTX_PART_MODE)) {
        int horiz = gp_bin(g, CTX_PART_MODE + 1);
        if (amp_here) {
            if (gp_bin(g, CTX_PART_MODE + 3)) part = horiz ? 1 : 2;
            else if (gp_byp(g)) part = horiz ? 4 : 6;
            else part = horiz ? 3 : 5;
        } else part = horiz ? 1 : 2;
    }
    for (int yy = y0 >> 2; yy < (y0 + n) >> 2; yy++)
        for (int xx = x0 >> 2; xx < (x0 + n) >> 2; xx++)
            g->mode4[(long)yy * g->w4 + xx] = 1;
    rc_mark_edges(g, x0, y0, n);
    int q = n >> 2;
    int pw[2], ph[2], npu;
    switch (part) {
        case 0: npu = 1; pw[0] = n; ph[0] = n; break;
        case 1: npu = 2; pw[0] = n; ph[0] = n >> 1; pw[1] = n; ph[1] = n >> 1; break;
        case 2: npu = 2; pw[0] = n >> 1; ph[0] = n; pw[1] = n >> 1; ph[1] = n; break;
        case 3: npu = 2; pw[0] = n; ph[0] = q; pw[1] = n; ph[1] = n - q; break;
        case 4: npu = 2; pw[0] = n; ph[0] = 3 * q; pw[1] = n; ph[1] = n - 3 * q; break;
        case 5: npu = 2; pw[0] = q; ph[0] = n; pw[1] = n - q; ph[1] = n; break;
        default: npu = 2; pw[0] = 3 * q; ph[0] = n; pw[1] = n - 3 * q; ph[1] = n; break;
    }
    int pux[2] = {x0, x0}, puy[2] = {y0, y0};
    if (npu == 2) {
        if (PART_HORIZ(part)) { puy[1] = y0 + ph[0]; rc_mark_edges(g, x0, puy[1], n); }
        else { pux[1] = x0 + pw[0]; rc_mark_edges(g, pux[1], y0, n); }
    }
    int merged_2nx2n = 0;
    for (int pi = 0; pi < npu; pi++) {
        if (gp_bin(g, CTX_MERGE_FLAG)) {
            int idx = gp_merge_idx(g);
            if (part == 0) merged_2nx2n = 1;
            if (g->rc) {
                if (g->slice_type == 0) {
                    BM lst[8];
                    rc_merge_list_b(g, pux[pi], puy[pi], pw[pi], ph[pi], part, pi, lst);
                    BM m = lst[idx];
                    if (pw[pi] + ph[pi] == 12 && m.pf[0] && m.pf[1])
                        m.pf[1] = 0;  /* 8x4/4x8 may not be bi (8.5.3.2.3) */
                    rc_commit_b(g, pux[pi], puy[pi], pw[pi], ph[pi], &m, 0);
                } else {
                    PM lst[8];
                    rc_merge_list_p(g, pux[pi], puy[pi], pw[pi], ph[pi], part, pi, lst);
                    rc_commit_p(g, pux[pi], puy[pi], pw[pi], ph[pi], lst[idx], 0);
                }
            }
        } else {
            if (g->slice_type == 0) {
                BM m;
                gp_pu_b(g, pux[pi], puy[pi], pw[pi], ph[pi], log2, &m);
                if (g->rc) rc_commit_b(g, pux[pi], puy[pi], pw[pi], ph[pi], &m, 0);
            } else {
                PM m;
                gp_pu_p(g, pux[pi], puy[pi], pw[pi], ph[pi], &m);
                if (g->rc) rc_commit_p(g, pux[pi], puy[pi], pw[pi], ph[pi], m, 0);
            }
        }
    }
    /* rqt_root_cbf coded unless 2Nx2N merge (7.3.8.5) */
    int root = 1;
    if (!merged_2nx2n) root = gp_bin(g, CTX_RQT_ROOT_CBF);
    if (root)
        gp_tt_inter(g, x0, y0, log2, 0, 1, 1, part != 0);
}

/* ---- coding quadtree ---- */
static void gp_cqt(GP *g, int x0, int y0, int log2, int depth) {
    if (g->err) return;
    int n = 1 << log2;
    int inside = (x0 + n <= g->w) && (y0 + n <= g->h);
    int split;
    if (log2 > g->min_cb && inside) {
        int ctx = 0;
        if (x0 > 0 && gp_same_slice(g, x0 - 1, y0)
                && g->depth4[(long)(y0 >> 2) * g->w4 + ((x0 - 1) >> 2)] > depth) ctx++;
        if (y0 > 0 && gp_same_slice(g, x0, y0 - 1)
                && g->depth4[(long)((y0 - 1) >> 2) * g->w4 + (x0 >> 2)] > depth) ctx++;
        split = gp_bin(g, CTX_SPLIT_CU_FLAG + ctx);
    } else split = log2 > g->min_cb;
    if (split) {
        int hh = n >> 1;
        static const int zo[4][2] = {{0,0},{0,1},{1,0},{1,1}};
        for (int j = 0; j < 4; j++) {
            int nx = x0 + zo[j][1] * hh, ny = y0 + zo[j][0] * hh;
            if (nx < g->w && ny < g->h)
                gp_cqt(g, nx, ny, log2 - 1, depth + 1);
        }
        return;
    }
    for (int yy = y0 >> 2; yy < (y0 + n) >> 2 && yy < g->h4; yy++)
        for (int xx = x0 >> 2; xx < (x0 + n) >> 2 && xx < g->w4; xx++)
            g->depth4[(long)yy * g->w4 + xx] = depth;
    if (g->cuqp) gp_enter_qg(g, x0, y0);
    gp_cu(g, x0, y0, log2);
    if (g->cuqp && g->rc) {
        /* the CU's final QpY feeds the prediction chain + maps (8.6.1) */
        RC *rc = g->rc;
        rc->qp_prev = rc->qp;
        for (int yy = y0 >> 2; yy < (y0 + n) >> 2 && yy < g->h4; yy++)
            for (int xx = x0 >> 2; xx < (x0 + n) >> 2 && xx < g->w4; xx++)
                rc->qp4[(long)yy * g->w4 + xx] = rc->qp;
    }
}

/* cfgv layout (see native/__init__.py parse_generic_slice):
   [0] w  [1] h  [2] ctb_log2  [3] min_cb_log2  [4] min_tb_log2
   [5] max_tb_log2  [6] td_intra  [7] td_inter  [8] amp  [9] sdh
   [10] tskip  [11] cu_qp_delta  [12] qg_log2  [13] pcm_min(-1 off)
   [14] pcm_max  [15] pcm_bd  [16] pcm_bd_c  [17] slice_type
   [18] nref0  [19] nref1  [20] max_merge  [21] mvd_l1_zero
   [22] sao_luma  [23] sao_chroma */
static void gp_config(GP *g, const int32_t *cfgv) {
    g->w = cfgv[0]; g->h = cfgv[1]; g->cl = cfgv[2]; g->min_cb = cfgv[3];
    g->min_tb = cfgv[4]; g->max_tb = cfgv[5]; g->td_intra = cfgv[6];
    g->td_inter = cfgv[7]; g->amp = cfgv[8]; g->sdh = cfgv[9];
    g->tskip = cfgv[10]; g->cuqp = cfgv[11]; g->qg_log2 = cfgv[12];
    g->pcm_min = cfgv[13]; g->pcm_max = cfgv[14]; g->pcm_bd = cfgv[15];
    g->pcm_bd_c = cfgv[16]; g->slice_type = cfgv[17]; g->nref0 = cfgv[18];
    g->nref1 = cfgv[19]; g->max_merge = cfgv[20]; g->mvd_l1_zero = cfgv[21];
    g->sao_luma = cfgv[22]; g->sao_chroma = cfgv[23];
    g->cw = (g->w + (1 << g->cl) - 1) >> g->cl;
    g->ch = (g->h + (1 << g->cl) - 1) >> g->cl;
    g->w4 = g->w >> 2; g->h4 = g->h >> 2;
    g->qg_key = -1;
}

/* shared segment loop: CABAC init/ctx carry, CTU loop, terminates */
static long gp_run(GP *g, const uint8_t *payload, long len, int init_type,
                   int slice_qp, int continue_ctx,
                   long ctb_from, long ctb_to, long slice_last,
                   int subset_term, long snap_after, uint8_t *ctx_snap,
                   uint8_t *ctx_state) {
    dec_init(&g->d, payload, len, init_type, slice_qp);
    if (continue_ctx) {
        memcpy(g->d.state, ctx_state, NUM_CONTEXTS);
        memcpy(g->d.mps, ctx_state + NUM_CONTEXTS, NUM_CONTEXTS);
    }
    int sao_on = g->sao_luma || g->sao_chroma;
    int prev_ct[1] = {0};
    for (long i = ctb_from; i < ctb_to; i++) {
        if (sao_on) gp_sao(g, i, prev_ct);
        int x0 = (int)(i % g->cw) << g->cl;
        int y0 = (int)(i / g->cw) << g->cl;
        gp_cqt(g, x0, y0, g->cl, 0);
        if (i == snap_after && ctx_snap) {
            memcpy(ctx_snap, g->d.state, NUM_CONTEXTS);
            memcpy(ctx_snap + NUM_CONTEXTS, g->d.mps, NUM_CONTEXTS);
        }
        int end = gp_term(g);
        if (g->err) return g->err;
        if (end != ((i == slice_last) ? 1 : 0)) return -25;
    }
    if (subset_term && ctb_to - 1 != slice_last) {
        /* end_of_subset_one_bit terminating a WPP row substream */
        if (gp_term(g) != 1) return -26;
        if (g->err) return g->err;
    }
    memcpy(ctx_state, g->d.state, NUM_CONTEXTS);
    memcpy(ctx_state + NUM_CONTEXTS, g->d.mps, NUM_CONTEXTS);
    return 0;
}

long parse_generic_slice_c(
    const uint8_t *payload, long len, int init_type, int slice_qp,
    int continue_ctx, const int32_t *cfgv,
    long ctb_from, long ctb_to,
    long slice_last, int subset_term, long snap_after, uint8_t *ctx_snap,
    const int32_t *slice_of, int cur_slice,
    int32_t *depth4, int32_t *skip4, int32_t *mode4,
    uint8_t *ctx_state,
    uint8_t *bins, long bins_cap,
    int32_t *levs, long levs_cap,
    int32_t *meta, long meta_cap,
    int32_t *pcm, long pcm_cap,
    long *out_lens)
{
    GP g;
    memset(&g, 0, sizeof g);
    gp_config(&g, cfgv);
    g.depth4 = depth4; g.skip4 = skip4; g.mode4 = mode4;
    g.slice_of = slice_of; g.cur_slice = cur_slice;
    g.bins = bins; g.bins_cap = bins_cap;
    g.levs = levs; g.levs_cap = levs_cap;
    g.meta = meta; g.meta_cap = meta_cap;
    g.pcm = pcm; g.pcm_cap = pcm_cap;
    long ret = gp_run(&g, payload, len, init_type, slice_qp, continue_ctx,
                      ctb_from, ctb_to, slice_last, subset_term, snap_after,
                      ctx_snap, ctx_state);
    if (ret != 0) return ret;
    out_lens[0] = g.bins_n;
    out_lens[1] = g.levs_n;
    out_lens[2] = g.meta_n;
    out_lens[3] = g.pcm_n;
    return 0;
}

/* Shared recon-buffer wiring for the recon entries (single-segment and
   WPP row-parallel): everything the GP/RC pair needs beyond the CABAC
   segment itself.
   rcfg: [0] strong_smoothing [1] cb_off [2] cr_off [3] cur_poc
         [4] has_col [5] col_poc [6] has_weights
   wt (when has_weights): [0] luma_denom [1] chroma_denom, then per l0 ref
   (lw, lo, cbw, cbo, crw, cro) x nref0, then the same x nref1. */
typedef struct ReconArgs {
    const int32_t *cfgv;
    const int32_t *slice_of; int cur_slice;
    int32_t *depth4, *skip4, *mode4;
    const int32_t *rcfg;
    int32_t *ycv, *ucv, *vcv, *qp4;
    uint8_t *edge_v, *edge_h;
    int32_t *inter4, *mv4, *ref4, *refpoc4, *cbf4;
    uint8_t *pf4; int32_t *mv4l, *refpoc4l;
    int32_t *sao_typ, *sao_aux, *sao_offs;
    const int64_t *ref0_ptrs; const int32_t *ref0_poc;
    const int64_t *ref1_ptrs; const int32_t *ref1_poc;
    const int64_t *col_ptrs; const int32_t *wt;
    int slice_qp;
} ReconArgs;

static void ra_setup(GP *g, RC *rc, const ReconArgs *a) {
    memset(g, 0, sizeof *g);
    memset(rc, 0, sizeof *rc);
    gp_config(g, a->cfgv);
    g->depth4 = a->depth4; g->skip4 = a->skip4; g->mode4 = a->mode4;
    g->slice_of = a->slice_of; g->cur_slice = a->cur_slice;
    g->rc = rc;
    rc->y = a->ycv; rc->u = a->ucv; rc->v = a->vcv;
    rc->qp4 = a->qp4; rc->edge_v = a->edge_v; rc->edge_h = a->edge_h;
    rc->inter4 = a->inter4; rc->mv4 = a->mv4; rc->ref4 = a->ref4;
    rc->refpoc4 = a->refpoc4;
    rc->cbf4 = a->cbf4; rc->pf4 = a->pf4; rc->mv4l = a->mv4l;
    rc->refpoc4l = a->refpoc4l;
    rc->sao_typ = a->sao_typ; rc->sao_aux = a->sao_aux;
    rc->sao_offs = a->sao_offs;
    rc->ref0 = a->ref0_ptrs; rc->ref0_poc = a->ref0_poc;
    rc->ref1 = a->ref1_ptrs; rc->ref1_poc = a->ref1_poc;
    rc->strong_smoothing = a->rcfg[0];
    rc->cb_off = a->rcfg[1]; rc->cr_off = a->rcfg[2];
    rc->cur_poc = a->rcfg[3];
    rc->has_col = a->rcfg[4]; rc->col_poc = a->rcfg[5];
    if (rc->has_col && a->col_ptrs) {
        rc->col_inter4 = (const int32_t *)(intptr_t)a->col_ptrs[0];
        rc->col_mv4 = (const int32_t *)(intptr_t)a->col_ptrs[1];
        rc->col_refpoc4 = (const int32_t *)(intptr_t)a->col_ptrs[2];
    }
    rc->wt = a->rcfg[6] ? a->wt : NULL;
    rc->w2 = g->w >> 1; rc->h2 = g->h >> 1;
    rc->w8 = g->w >> 3; rc->h8 = g->h >> 3;
    rc->slice_qp = a->slice_qp;
    rc->qp_prev = a->slice_qp;  /* qPY_PREV init per segment/row (8.6.1) */
    rc->qg_pred = a->slice_qp;
    rc_set_qp(g, a->slice_qp);
}

/* Recon entry: decode-and-reconstruct one slice segment directly into the
   Python decoder's buffers (canvases, 4x4 maps, SAO params, edge marks). */
long recon_generic_slice_c(
    const uint8_t *payload, long len, int init_type, int slice_qp,
    int continue_ctx, const int32_t *cfgv,
    long ctb_from, long ctb_to,
    long slice_last, int subset_term, long snap_after, uint8_t *ctx_snap,
    const int32_t *slice_of, int cur_slice,
    int32_t *depth4, int32_t *skip4, int32_t *mode4,
    uint8_t *ctx_state,
    const int32_t *rcfg,
    int32_t *ycv, int32_t *ucv, int32_t *vcv,
    int32_t *qp4, uint8_t *edge_v, uint8_t *edge_h,
    int32_t *inter4, int32_t *mv4, int32_t *ref4, int32_t *refpoc4,
    int32_t *cbf4, uint8_t *pf4, int32_t *mv4l, int32_t *refpoc4l,
    int32_t *sao_typ, int32_t *sao_aux, int32_t *sao_offs,
    const int64_t *ref0_ptrs, const int32_t *ref0_poc,
    const int64_t *ref1_ptrs, const int32_t *ref1_poc,
    const int64_t *col_ptrs,
    const int32_t *wt)
{
    GP g;
    RC rc;
    ReconArgs a = {cfgv, slice_of, cur_slice, depth4, skip4, mode4, rcfg,
                   ycv, ucv, vcv, qp4, edge_v, edge_h,
                   inter4, mv4, ref4, refpoc4, cbf4, pf4, mv4l, refpoc4l,
                   sao_typ, sao_aux, sao_offs,
                   ref0_ptrs, ref0_poc, ref1_ptrs, ref1_poc,
                   col_ptrs, wt, slice_qp};
    ra_setup(&g, &rc, &a);
    return gp_run(&g, payload, len, init_type, slice_qp, continue_ctx,
                  ctb_from, ctb_to, slice_last, subset_term, snap_after,
                  ctx_snap, ctx_state);
}

/* ---- WPP row-parallel reconstruction (openHEVC-style wavefront decode).

   One slice whose segment is split into per-CTB-row substreams
   (entropy_coding_sync, 9.3.1): rows run on worker threads under the
   standard 2-CTU wavefront skew — row r may reconstruct CTU column c
   only after row r-1 has completed column c+1, which covers every
   cross-row dependency (intra up/up-right reference samples reach at
   most the above row's c+1 CTU, merge/AMVP B0 reads the above-right
   4x4 cell, SAO merge-up reads the above CTU's params, cu_qp_delta
   prediction reads the above qp4 cells) — and CABAC context inheritance
   from the snapshot after the above row's second CTU (9.3.2.3).
   Mirrors the sequential per-row loop in decoder/native_recon.py; the
   Python caller guarantees full rows (ctb_from/ctb_to on row bounds). */
typedef struct RWRow {
    struct RWPic *pic;
    int row;                    /* picture CTB row index */
    const uint8_t *data;        /* this row's substream */
    long len;
    uint8_t ctx1[2 * NUM_CONTEXTS];
    int ctx1_ready;             /* snapshot after 2nd CTU published */
    long done;                  /* CTU columns completed in this row */
    long err;
    pthread_mutex_t mu;
    pthread_cond_t cv;
    struct RWRow *prev;
} RWRow;

typedef struct RWPic {
    ReconArgs a;
    int init_type, slice_qp;
    long ctb_from, ctb_to, slice_last;
    RWRow *rows;
    int nrows, nthreads;
} RWPic;

static void rw_finish_row(RWRow *r, long err, int cw) {
    pthread_mutex_lock(&r->mu);
    r->err = err;
    r->done = cw;               /* release successors even on error */
    r->ctx1_ready = 1;
    pthread_cond_broadcast(&r->cv);
    pthread_mutex_unlock(&r->mu);
}

static long rw_run_row(RWPic *p, RWRow *r) {
    GP g;
    RC rc;
    ra_setup(&g, &rc, &p->a);
    int cw = g.cw;
    long row_st = p->ctb_from + (long)r->row * cw;
    long row_en = row_st + cw;
    if (row_en > p->ctb_to) row_en = p->ctb_to;
    dec_init(&g.d, r->data, r->len, p->init_type, p->slice_qp);
    if (r->row > 0 && cw > 1) {
        RWRow *pv = r->prev;
        pthread_mutex_lock(&pv->mu);
        while (!pv->ctx1_ready) pthread_cond_wait(&pv->cv, &pv->mu);
        long perr = pv->err;
        pthread_mutex_unlock(&pv->mu);
        if (perr) return perr;
        memcpy(g.d.state, pv->ctx1, NUM_CONTEXTS);
        memcpy(g.d.mps, pv->ctx1 + NUM_CONTEXTS, NUM_CONTEXTS);
    }
    int sao_on = g.sao_luma || g.sao_chroma;
    int prev_ct[1] = {0};
    for (long i = row_st; i < row_en; i++) {
        long c = i - row_st;
        if (r->row > 0) {
            RWRow *pv = r->prev;
            long need = c + 2;
            if (need > cw) need = cw;
            pthread_mutex_lock(&pv->mu);
            while (pv->done < need) pthread_cond_wait(&pv->cv, &pv->mu);
            long perr = pv->err;
            pthread_mutex_unlock(&pv->mu);
            if (perr) return perr;
        }
        if (sao_on) gp_sao(&g, i, prev_ct);
        int x0 = (int)(i % g.cw) << g.cl;
        int y0 = (int)(i / g.cw) << g.cl;
        gp_cqt(&g, x0, y0, g.cl, 0);
        if (g.err) return g.err;
        int end = gp_term(&g);
        if (g.err) return g.err;
        if (end != ((i == p->slice_last) ? 1 : 0)) return -25;
        pthread_mutex_lock(&r->mu);
        r->done = c + 1;
        if (c == 1) {
            memcpy(r->ctx1, g.d.state, NUM_CONTEXTS);
            memcpy(r->ctx1 + NUM_CONTEXTS, g.d.mps, NUM_CONTEXTS);
            r->ctx1_ready = 1;
        }
        pthread_cond_broadcast(&r->cv);
        pthread_mutex_unlock(&r->mu);
    }
    if (row_en - 1 != p->slice_last) {
        /* end_of_subset_one_bit terminating a WPP row substream */
        if (gp_term(&g) != 1) return -26;
        if (g.err) return g.err;
    }
    return 0;
}

static void *rw_worker(void *arg) {
    RWRow *r0 = (RWRow *)arg;
    RWPic *p = r0->pic;
    int cw = ((p->a.cfgv[0] + (1 << p->a.cfgv[2]) - 1) >> p->a.cfgv[2]);
    /* strided row assignment: worker t owns rows t, t+T, t+2T, ... so
       each worker sees its rows in wavefront (topological) order.  On
       error, keep walking and mark every remaining owned row finished
       (failed) — successors block on those rows' sync cells and would
       deadlock if a row were abandoned. */
    long err = 0;
    for (int row = r0->row; row < p->nrows; row += p->nthreads) {
        RWRow *r = &p->rows[row];
        if (!err) err = rw_run_row(p, r);
        rw_finish_row(r, err, cw);
    }
    return NULL;
}

long recon_generic_wpp_c(
    const uint8_t *payload, const int64_t *bounds, int nrows, int nthreads,
    int init_type, int slice_qp, const int32_t *cfgv,
    long ctb_from, long ctb_to, long slice_last,
    const int32_t *slice_of, int cur_slice,
    int32_t *depth4, int32_t *skip4, int32_t *mode4,
    const int32_t *rcfg,
    int32_t *ycv, int32_t *ucv, int32_t *vcv,
    int32_t *qp4, uint8_t *edge_v, uint8_t *edge_h,
    int32_t *inter4, int32_t *mv4, int32_t *ref4, int32_t *refpoc4,
    int32_t *cbf4, uint8_t *pf4, int32_t *mv4l, int32_t *refpoc4l,
    int32_t *sao_typ, int32_t *sao_aux, int32_t *sao_offs,
    const int64_t *ref0_ptrs, const int32_t *ref0_poc,
    const int64_t *ref1_ptrs, const int32_t *ref1_poc,
    const int64_t *col_ptrs,
    const int32_t *wt)
{
    RWPic p;
    memset(&p, 0, sizeof p);
    ReconArgs a = {cfgv, slice_of, cur_slice, depth4, skip4, mode4, rcfg,
                   ycv, ucv, vcv, qp4, edge_v, edge_h,
                   inter4, mv4, ref4, refpoc4, cbf4, pf4, mv4l, refpoc4l,
                   sao_typ, sao_aux, sao_offs,
                   ref0_ptrs, ref0_poc, ref1_ptrs, ref1_poc,
                   col_ptrs, wt, slice_qp};
    p.a = a;
    p.init_type = init_type; p.slice_qp = slice_qp;
    p.ctb_from = ctb_from; p.ctb_to = ctb_to; p.slice_last = slice_last;
    p.nrows = nrows;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > nrows) nthreads = nrows;
    p.nthreads = nthreads;
    p.rows = (RWRow *)calloc((size_t)nrows, sizeof(RWRow));
    if (!p.rows) return -30;
    for (int r = 0; r < nrows; r++) {
        p.rows[r].pic = &p;
        p.rows[r].row = r;
        p.rows[r].data = payload + bounds[r];
        p.rows[r].len = bounds[r + 1] - bounds[r];
        p.rows[r].prev = r > 0 ? &p.rows[r - 1] : NULL;
        pthread_mutex_init(&p.rows[r].mu, NULL);
        pthread_cond_init(&p.rows[r].cv, NULL);
    }
    long ret = 0;
    int cw = (cfgv[0] + (1 << cfgv[2]) - 1) >> cfgv[2];
    if (nthreads == 1) {
        for (int r = 0; r < nrows && ret == 0; r++) {
            ret = rw_run_row(&p, &p.rows[r]);
            rw_finish_row(&p.rows[r], ret, cw);
        }
    } else {
        pthread_t *tids = (pthread_t *)malloc(sizeof(pthread_t) * nthreads);
        int started = 0;
        for (int t = 0; t < nthreads; t++) {
            if (pthread_create(&tids[t], NULL, rw_worker, &p.rows[t]) != 0)
                break;  /* thread limit: orphaned rows run inline below */
            started++;
        }
        if (started < nthreads) {
            /* Rows owned by un-started workers run inline in ascending
               (wavefront-topological) order: any wait is on a smaller row,
               which either has a live worker or ran earlier in this loop,
               so progress is guaranteed.  Error semantics match rw_worker:
               once an inline row fails, remaining inline rows are marked
               finished so successors never deadlock. */
            long ierr = 0;
            for (int row = 0; row < nrows; row++) {
                if (row % nthreads < started) continue;
                RWRow *r = &p.rows[row];
                if (!ierr) ierr = rw_run_row(&p, r);
                rw_finish_row(r, ierr, cw);
            }
        }
        for (int t = 0; t < started; t++)
            pthread_join(tids[t], NULL);
        free(tids);
        for (int r = 0; r < nrows; r++)
            if (p.rows[r].err) { ret = p.rows[r].err; break; }
    }
    for (int r = 0; r < nrows; r++) {
        pthread_mutex_destroy(&p.rows[r].mu);
        pthread_cond_destroy(&p.rows[r].cv);
    }
    free(p.rows);
    return ret;
}

/* ==================================================================== */
/* Deblock boundary strengths (8.7.2.4) from the decoded 4x4 maps,      */
/* mirroring generic_inter.bs_maps (P rule) / generic_b.bs_maps (B      */
/* full rule: hypothesis counts, ref-picture sets, per-list or          */
/* cross-list MV compares).  bs_v: (w8-1, h4); bs_h: (h8-1, w4).        */

static int bs_big(const int32_t *m0, const int32_t *m1) {
    int dx = m0[0] - m1[0]; if (dx < 0) dx = -dx;
    int dy = m0[1] - m1[1]; if (dy < 0) dy = -dy;
    return dx >= 4 || dy >= 4;
}

static int bs_mv_cell_b(const uint8_t *pf4, const int32_t *mv4l,
                        const int32_t *rp4l, long ca, long cb) {
    const uint8_t *pa = pf4 + ca * 2, *pb = pf4 + cb * 2;
    const int32_t *ma = mv4l + ca * 4, *mb = mv4l + cb * 4;
    const int32_t *ra = rp4l + ca * 2, *rb = rp4l + cb * 2;
    int na = pa[0] + pa[1], nb = pb[0] + pb[1];
    if (na != nb) return 1;
    if (na == 1) {
        int la = pa[0] ? 0 : 1, lb = pb[0] ? 0 : 1;
        if (ra[la] != rb[lb]) return 1;
        return bs_big(ma + la * 2, mb + lb * 2);
    }
    /* bi vs bi: ref-picture sets must match */
    int same = (ra[0] == rb[0] && ra[1] == rb[1])
            || (ra[0] == rb[1] && ra[1] == rb[0]);
    if (!same) return 1;
    if (ra[0] != ra[1]) {  /* two distinct pictures: match by picture */
        for (int l = 0; l < 2; l++) {
            int lb = (rb[0] == ra[l]) ? 0 : 1;
            if (bs_big(ma + l * 2, mb + lb * 2)) return 1;
        }
        return 0;
    }
    /* same picture both hypotheses: either pairing may satisfy */
    int straight = !bs_big(ma, mb) && !bs_big(ma + 2, mb + 2);
    int crossed = !bs_big(ma, mb + 2) && !bs_big(ma + 2, mb);
    return !(straight || crossed);
}

void bs_maps_c(int is_b, int w4, int h4, int w8, int h8,
               const int32_t *inter4, const int32_t *cbf4,
               const uint8_t *edge_v, const uint8_t *edge_h,
               const int32_t *mv4, const int32_t *refpoc4,
               const uint8_t *pf4, const int32_t *mv4l,
               const int32_t *refpoc4l,
               int32_t *bs_v, int32_t *bs_h)
{
    for (int e = 1; e < w8; e++) {
        int c4 = 2 * e;
        int32_t *row = bs_v + (long)(e - 1) * h4;
        for (int r = 0; r < h4; r++) {
            if (!edge_v[(long)(r >> 1) * w8 + e]) { row[r] = 0; continue; }
            long cp = (long)r * w4 + c4 - 1, cq = (long)r * w4 + c4;
            if (!inter4[cp] || !inter4[cq]) { row[r] = 2; continue; }
            if (cbf4[cp] || cbf4[cq]) { row[r] = 1; continue; }
            if (is_b) row[r] = bs_mv_cell_b(pf4, mv4l, refpoc4l, cp, cq);
            else row[r] = (refpoc4[cp] != refpoc4[cq]
                           || bs_big(mv4 + cp * 2, mv4 + cq * 2)) ? 1 : 0;
        }
    }
    for (int e = 1; e < h8; e++) {
        int r4 = 2 * e;
        int32_t *row = bs_h + (long)(e - 1) * w4;
        for (int c = 0; c < w4; c++) {
            if (!edge_h[(long)e * w8 + (c >> 1)]) { row[c] = 0; continue; }
            long cp = (long)(r4 - 1) * w4 + c, cq = (long)r4 * w4 + c;
            if (!inter4[cp] || !inter4[cq]) { row[c] = 2; continue; }
            if (cbf4[cp] || cbf4[cq]) { row[c] = 1; continue; }
            if (is_b) row[c] = bs_mv_cell_b(pf4, mv4l, refpoc4l, cp, cq);
            else row[c] = (refpoc4[cp] != refpoc4[cq]
                           || bs_big(mv4 + cp * 2, mv4 + cq * 2)) ? 1 : 0;
        }
    }
}

/* ==================================================================== */
/* In-loop filters for the decode path: deblocking (8.7.2, spacing 8,   */
/* 4-sample bS segments) then SAO (8.7.3), mirroring ops/deblock.py     */
/* deblock_frame + ops/sao.py sao_apply exactly (V pass over the whole  */
/* picture, H pass on the V-filtered samples, SAO classifying on the    */
/* fully deblocked picture).  8-bit.                                    */

static const uint8_t DB_BETA[52] = {
    0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
    6,7,8,9,10,11,12,13,14,15,16,17,18,20,22,24,26,28,
    30,32,34,36,38,40,42,44,46,48,50,52,54,56,58,60,62,64};
static const uint8_t DB_TC[54] = {
    0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
    1,1,1,1,1,1,1,1,1,2,2,2,2,3,3,3,3,4,4,4,5,5,
    6,6,7,8,9,10,11,13,14,16,18,20,22,24};

static int db_clip3(int x, int lo, int hi) {
    return x < lo ? lo : x > hi ? hi : x;
}

/* filter one 4-line luma group across an edge; px(line, i) returns a
   pointer to sample i of the 8-slab [p3 p2 p1 p0 q0 q1 q2 q3] */
static void db_luma_group(int32_t *s[4][8], int beta, int tc) {
    if (tc == 0 && beta == 0) return;
#define P(l, i) (*s[l][3 - (i)])
#define Q(l, i) (*s[l][4 + (i)])
    int dp0 = abs(P(0,2) - 2 * P(0,1) + P(0,0));
    int dq0 = abs(Q(0,2) - 2 * Q(0,1) + Q(0,0));
    int dp3 = abs(P(3,2) - 2 * P(3,1) + P(3,0));
    int dq3 = abs(Q(3,2) - 2 * Q(3,1) + Q(3,0));
    int d = dp0 + dq0 + dp3 + dq3;
    if (d >= beta) return;
    int strong = 1;
    for (int i = 0; i < 4; i += 3) {
        int dpi = abs(P(i,2) - 2 * P(i,1) + P(i,0));
        int dqi = abs(Q(i,2) - 2 * Q(i,1) + Q(i,0));
        if (!(2 * (dpi + dqi) < (beta >> 2)
              && abs(P(i,3) - P(i,0)) + abs(Q(i,0) - Q(i,3)) < (beta >> 3)
              && abs(P(i,0) - Q(i,0)) < ((5 * tc + 1) >> 1)))
            strong = 0;
    }
    int side = (beta + (beta >> 1)) >> 3;
    int dEp = (dp0 + dp3) < side, dEq = (dq0 + dq3) < side;
    for (int l = 0; l < 4; l++) {
        int p3 = P(l,3), p2 = P(l,2), p1 = P(l,1), p0 = P(l,0);
        int q0 = Q(l,0), q1 = Q(l,1), q2 = Q(l,2), q3 = Q(l,3);
        if (strong) {
            int t2 = 2 * tc;
            P(l,0) = db_clip3(p0 + db_clip3(((p2 + 2*p1 + 2*p0 + 2*q0 + q1 + 4) >> 3) - p0, -t2, t2), 0, 255);
            P(l,1) = db_clip3(p1 + db_clip3(((p2 + p1 + p0 + q0 + 2) >> 2) - p1, -t2, t2), 0, 255);
            P(l,2) = db_clip3(p2 + db_clip3(((2*p3 + 3*p2 + p1 + p0 + q0 + 4) >> 3) - p2, -t2, t2), 0, 255);
            Q(l,0) = db_clip3(q0 + db_clip3(((q2 + 2*q1 + 2*q0 + 2*p0 + p1 + 4) >> 3) - q0, -t2, t2), 0, 255);
            Q(l,1) = db_clip3(q1 + db_clip3(((q2 + q1 + q0 + p0 + 2) >> 2) - q1, -t2, t2), 0, 255);
            Q(l,2) = db_clip3(q2 + db_clip3(((2*q3 + 3*q2 + q1 + q0 + p0 + 4) >> 3) - q2, -t2, t2), 0, 255);
        } else {
            int delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4;
            if (abs(delta) < 10 * tc) {
                int dlt = db_clip3(delta, -tc, tc);
                P(l,0) = db_clip3(p0 + dlt, 0, 255);
                Q(l,0) = db_clip3(q0 - dlt, 0, 255);
                if (dEp)
                    P(l,1) = db_clip3(p1 + db_clip3((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -(tc >> 1), tc >> 1), 0, 255);
                if (dEq)
                    Q(l,1) = db_clip3(q1 + db_clip3((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -(tc >> 1), tc >> 1), 0, 255);
            }
        }
    }
#undef P
#undef Q
}

static int db_edge_qp(const int32_t *qm, int w8, int slice_qp,
                      int blk_a, int blk_b) {
    if (!qm) return slice_qp;
    return (qm[blk_a] + qm[blk_b] + 1) >> 1;
    (void)w8;
}

/* SAO for one plane: src (deblocked int32) -> dst uint8.  Rows strided
   (yy = y_from, y_from+y_step, ...) so worker threads split a plane. */
static void sao_plane_c(const int32_t *src, uint8_t *dst, int W, int H,
                        int ctb, int cw, long nctb, int comp,
                        const int32_t *typ, const int32_t *aux,
                        const int32_t *offs, long y_from, long y_step) {
    static const int EOD[4][4] = {   /* hPos0 vPos0 hPos1 vPos1 */
        {-1, 0, 1, 0}, {0, -1, 0, 1}, {-1, -1, 1, 1}, {1, -1, -1, 1}};
    for (long yy = y_from; yy < H; yy += y_step) {
        long crow = (yy / ctb) * cw;
        for (long xx = 0; xx < W; xx++) {
            long ci = crow + xx / ctb;
            int t = typ[comp * nctb + ci];
            int r = src[yy * W + xx];
            int off = 0;
            if (t == 2) {
                int cls = aux[comp * nctb + ci];
                int dx0 = EOD[cls][0], dy0 = EOD[cls][1];
                int dx1 = EOD[cls][2], dy1 = EOD[cls][3];
                if (xx + dx0 >= 0 && xx + dx0 < W && xx + dx1 >= 0 && xx + dx1 < W
                        && yy + dy0 >= 0 && yy + dy0 < H
                        && yy + dy1 >= 0 && yy + dy1 < H) {
                    int n0 = src[(yy + dy0) * W + xx + dx0];
                    int n1 = src[(yy + dy1) * W + xx + dx1];
                    int raw = 2 + (r > n0 ? 1 : r < n0 ? -1 : 0)
                                + (r > n1 ? 1 : r < n1 ? -1 : 0);
                    int idx = raw == 2 ? 0 : raw < 2 ? raw + 1 : raw;
                    if (idx > 0) off = offs[(comp * nctb + ci) * 4 + idx - 1];
                }
            } else if (t == 1) {
                int brel = ((r >> 3) - aux[comp * nctb + ci]) & 31;
                if (brel < 4) off = offs[(comp * nctb + ci) * 4 + brel];
            }
            int vout = r + off;
            dst[yy * W + xx] = (uint8_t)(vout < 0 ? 0 : vout > 255 ? 255 : vout);
        }
    }
}

/* bs_v: (w8-1, h4); bs_h: (h8-1, w4) — 4-sample segments (native
   bs_maps_c layout).  qp_map8: (h8, w8) per-8-block QpY or NULL.

   Worker-strided: vertical edge columns write disjoint 8-px spans
   ([8e-4, 8e+3] for edge e), so the V pass parallelizes over e; the H
   pass (which reads the V-filtered picture) runs after a barrier and
   parallelizes over edge rows the same way; SAO reads the frozen
   deblocked planes, so its rows split freely.  Chroma V rides the
   luma-V pass (different plane) and chroma H the H pass. */
typedef struct DSArgs {
    int w, h, ctb_log2, slice_qp, beta_off, tc_off, cb_off, cr_off;
    int do_deblock, sao_luma, sao_chroma;
    int32_t *y, *u, *v;
    const int32_t *bs_v, *bs_h, *qp_map8;
    const int32_t *sao_typ, *sao_aux, *sao_offs;
    uint8_t *oy, *ou, *ov;
    int nthreads;
    pthread_barrier_t bar;  /* NOTE: pthread barriers are optional POSIX
                               (absent on Darwin) — this .so is Linux-only,
                               documented in native/__init__.py */
    int go;                 /* start gate: 0 wait, 1 run, -1 abort */
    pthread_mutex_t gmu;
    pthread_cond_t gcv;
} DSArgs;

static void ds_run(DSArgs *d, int t) {
    int T = d->nthreads;
    int w = d->w, h = d->h;
    int w8 = w >> 3, h8 = h >> 3, h4 = h >> 2, w4 = w >> 2;
    int w2 = w >> 1, h2 = h >> 1;
    int32_t *y = d->y;
    int32_t *planes[2] = {d->u, d->v};
    int coffs[2] = {d->cb_off, d->cr_off};
    if (d->do_deblock) {
        /* ---- pass 1: luma vertical edges (strided over edge columns) */
        for (int e = 1 + t; e < w8; e += T) {
            int x = 8 * e;
            for (int s4 = 0; s4 < h4; s4++) {
                int bs = d->bs_v[(long)(e - 1) * h4 + s4];
                if (!bs) continue;
                int qpe = db_edge_qp(d->qp_map8, w8, d->slice_qp,
                                     (s4 >> 1) * w8 + e - 1,
                                     (s4 >> 1) * w8 + e);
                int beta = DB_BETA[db_clip3(qpe + (d->beta_off << 1), 0, 51)];
                int tc = DB_TC[db_clip3(qpe + 2 * (bs - 1) + (d->tc_off << 1), 0, 53)];
                int32_t *s[4][8];
                for (int l = 0; l < 4; l++)
                    for (int i = 0; i < 8; i++)
                        s[l][i] = y + (long)(4 * s4 + l) * w + x - 4 + i;
                db_luma_group(s, beta, tc);
            }
        }
        /* ---- chroma vertical edges (other planes; same pass) */
        for (int p = 0; p < 2; p++) {
            int32_t *c = planes[p];
            /* vertical chroma edges at xc = 4*e; filter when e % 2 == 0 */
            for (int e = 1 + t; e < (w2 >> 2); e += T) {
                if (e % 2) continue;  /* on_grid: (idx+1) % 2 == 0 */
                int le = e;           /* luma-8 edge at x = 2*xc = 8e */
                int xc = 4 * e;
                for (int g = 0; g < (h2 >> 2); g++) {
                    /* 4 chroma rows 4g..4g+3 = luma rows 8g..8g+7 ->
                       luma segments 2g, 2g+1 */
                    int b0 = d->bs_v[(long)(le - 1) * h4 + 2 * g];
                    int b1 = d->bs_v[(long)(le - 1) * h4 + 2 * g + 1];
                    int bs = b0 > b1 ? b0 : b1;
                    if (bs != 2) continue;
                    int qpe = db_edge_qp(d->qp_map8, w8, d->slice_qp,
                                         g * w8 + le - 1, g * w8 + le);
                    int qpc = CHROMA_QP_TABLE[db_clip3(qpe + coffs[p], 0, 57)];
                    int tc = DB_TC[db_clip3(qpc + 2 + (d->tc_off << 1), 0, 53)];
                    if (!tc) continue;
                    for (int l = 0; l < 4; l++) {
                        int32_t *row = c + (long)(4 * g + l) * w2;
                        int p1 = row[xc - 2], p0 = row[xc - 1];
                        int q0 = row[xc], q1 = row[xc + 1];
                        int delta = db_clip3((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc);
                        row[xc - 1] = db_clip3(p0 + delta, 0, 255);
                        row[xc] = db_clip3(q0 - delta, 0, 255);
                    }
                }
            }
        }
        if (T > 1) pthread_barrier_wait(&d->bar);
        /* ---- pass 2: luma horizontal edges on the V-filtered picture */
        for (int e = 1 + t; e < h8; e += T) {
            int yy = 8 * e;
            for (int s4 = 0; s4 < w4; s4++) {
                int bs = d->bs_h[(long)(e - 1) * w4 + s4];
                if (!bs) continue;
                int qpe = db_edge_qp(d->qp_map8, w8, d->slice_qp,
                                     (e - 1) * w8 + (s4 >> 1),
                                     e * w8 + (s4 >> 1));
                int beta = DB_BETA[db_clip3(qpe + (d->beta_off << 1), 0, 51)];
                int tc = DB_TC[db_clip3(qpe + 2 * (bs - 1) + (d->tc_off << 1), 0, 53)];
                int32_t *s[4][8];
                for (int l = 0; l < 4; l++)
                    for (int i = 0; i < 8; i++)
                        s[l][i] = y + (long)(yy - 4 + i) * w + 4 * s4 + l;
                db_luma_group(s, beta, tc);
            }
        }
        /* ---- chroma horizontal edges */
        for (int p = 0; p < 2; p++) {
            int32_t *c = planes[p];
            for (int e = 1 + t; e < (h2 >> 2); e += T) {
                if (e % 2) continue;
                int le = e;
                int yc = 4 * e;
                for (int g = 0; g < (w2 >> 2); g++) {
                    int b0 = d->bs_h[(long)(le - 1) * w4 + 2 * g];
                    int b1 = d->bs_h[(long)(le - 1) * w4 + 2 * g + 1];
                    int bs = b0 > b1 ? b0 : b1;
                    if (bs != 2) continue;
                    int qpe = db_edge_qp(d->qp_map8, w8, d->slice_qp,
                                         (le - 1) * w8 + g, le * w8 + g);
                    int qpc = CHROMA_QP_TABLE[db_clip3(qpe + coffs[p], 0, 57)];
                    int tc = DB_TC[db_clip3(qpc + 2 + (d->tc_off << 1), 0, 53)];
                    if (!tc) continue;
                    for (int l = 0; l < 4; l++) {
                        int32_t *col = c + 4 * g + l;
                        int p1 = col[(long)(yc - 2) * w2], p0 = col[(long)(yc - 1) * w2];
                        int q0 = col[(long)yc * w2], q1 = col[(long)(yc + 1) * w2];
                        int delta = db_clip3((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc);
                        col[(long)(yc - 1) * w2] = db_clip3(p0 + delta, 0, 255);
                        col[(long)yc * w2] = db_clip3(q0 - delta, 0, 255);
                    }
                }
            }
        }
        if (T > 1) pthread_barrier_wait(&d->bar);
    }
    /* ---- pass 3: SAO on the deblocked picture (or plain clip-copy) */
    int ctb = 1 << d->ctb_log2;
    int cw = (w + ctb - 1) >> d->ctb_log2;
    int chh = (h + ctb - 1) >> d->ctb_log2;
    long nctb = (long)cw * chh;
    if (d->sao_luma)
        sao_plane_c(y, d->oy, w, h, ctb, cw, nctb, 0,
                    d->sao_typ, d->sao_aux, d->sao_offs, t, T);
    else
        for (long yy = t; yy < h; yy += T)
            for (long xx = 0; xx < w; xx++)
                d->oy[yy * w + xx] = (uint8_t)db_clip3(y[yy * w + xx], 0, 255);
    if (d->sao_chroma) {
        sao_plane_c(d->u, d->ou, w2, h2, ctb >> 1, cw, nctb, 1,
                    d->sao_typ, d->sao_aux, d->sao_offs, t, T);
        sao_plane_c(d->v, d->ov, w2, h2, ctb >> 1, cw, nctb, 2,
                    d->sao_typ, d->sao_aux, d->sao_offs, t, T);
    } else {
        for (long yy = t; yy < h2; yy += T)
            for (long xx = 0; xx < w2; xx++) {
                d->ou[yy * w2 + xx] = (uint8_t)db_clip3(d->u[yy * w2 + xx], 0, 255);
                d->ov[yy * w2 + xx] = (uint8_t)db_clip3(d->v[yy * w2 + xx], 0, 255);
            }
    }
}

typedef struct { DSArgs *d; int t; } DSTh;

static void *ds_thread(void *arg) {
    DSTh *a = (DSTh *)arg;
    DSArgs *d = a->d;
    /* Wait for the start gate: the spawner only releases workers once ALL
       of them exist, because the barrier counts d->nthreads participants —
       running with fewer would deadlock the barrier waits. */
    pthread_mutex_lock(&d->gmu);
    while (d->go == 0) pthread_cond_wait(&d->gcv, &d->gmu);
    int go = d->go;
    pthread_mutex_unlock(&d->gmu);
    if (go > 0) ds_run(d, a->t);
    return NULL;
}

void deblock_sao_c(
    int w, int h, int ctb_log2,
    int slice_qp, int beta_off, int tc_off, int cb_off, int cr_off,
    int do_deblock, int sao_luma, int sao_chroma,
    int nthreads,
    int32_t *y, int32_t *u, int32_t *v,
    const int32_t *bs_v, const int32_t *bs_h,
    const int32_t *qp_map8,
    const int32_t *sao_typ, const int32_t *sao_aux, const int32_t *sao_offs,
    uint8_t *oy, uint8_t *ou, uint8_t *ov)
{
    DSArgs d = {w, h, ctb_log2, slice_qp, beta_off, tc_off, cb_off, cr_off,
                do_deblock, sao_luma, sao_chroma,
                y, u, v, bs_v, bs_h, qp_map8,
                sao_typ, sao_aux, sao_offs, oy, ou, ov, 1};
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 64) nthreads = 64;
    if (nthreads > (h >> 3)) nthreads = (h >> 3) > 0 ? (h >> 3) : 1;
    d.nthreads = nthreads;
    if (nthreads == 1) {
        ds_run(&d, 0);
        return;
    }
    pthread_barrier_init(&d.bar, NULL, (unsigned)nthreads);
    pthread_mutex_init(&d.gmu, NULL);
    pthread_cond_init(&d.gcv, NULL);
    d.go = 0;
    pthread_t tids[64];
    DSTh th[64];
    int started = 1;  /* slot 0 is this thread */
    for (int t = 1; t < nthreads; t++) {
        th[t].d = &d; th[t].t = t;
        if (pthread_create(&tids[t], NULL, ds_thread, &th[t]) != 0)
            break;  /* thread limit: abort the gated workers, run solo */
        started++;
    }
    pthread_mutex_lock(&d.gmu);
    d.go = (started == nthreads) ? 1 : -1;
    pthread_cond_broadcast(&d.gcv);
    pthread_mutex_unlock(&d.gmu);
    if (started == nthreads) {
        ds_run(&d, 0);
        for (int t = 1; t < started; t++) pthread_join(tids[t], NULL);
    } else {
        for (int t = 1; t < started; t++) pthread_join(tids[t], NULL);
        d.nthreads = 1;  /* T==1 skips every barrier wait */
        ds_run(&d, 0);
    }
    pthread_barrier_destroy(&d.bar);
    pthread_mutex_destroy(&d.gmu);
    pthread_cond_destroy(&d.gcv);
}

/* ==================================================================== */
/* Quad-tree slice writer: the native twin of entropy/quad.py           */
/* (_QuadWriter/_QuadWriterP).  Input is a flat TOKEN stream describing */
/* the CU quadtrees plus a concatenated LEVELS buffer; a non-entropy    */
/* prepass resolves per-CTB cursors and the cross-row context maps      */
/* (depth4/mode4/skip4 — reads are always of scan-past positions, so    */
/* precomputing them is exact), then per-row WPP threads (or one        */
/* sequential stream) emit the bins.  Mirrors the Python writer         */
/* bit-for-bit; covers SAO params (7.3.8.3) and cu_qp_delta (QG==CTB).  */
/*                                                                      */
/* Token grammar per node (z-order recursion):                          */
/*   log2 > min_cb:             [split]                                 */
/*   P leaf:                    [ctype] + (skip/merge: [merge_idx] |    */
/*                              amvp: [mvd_x mvd_y mvp_flag])           */
/*   intra leaf (I, or P ct=0): [nxn] [mode x (nxn?4:1)] [tsplit]       */
/* Levels per leaf: lev_y (n^2) + lev_cb + lev_cr ((n/2)^2 each),       */
/* raster int32, in walk order.                                         */

typedef struct {
    const int32_t *toks;
    const int32_t *levs;
    int cw, chh, ctb_log2, min_cb_log2, td_intra, slice_type, merge_k;
    int w4, h4;              /* 4x4 map dims */
    int8_t *depth4;
    int32_t *mode4;
    uint8_t *skip4;
    const int32_t *sao_typ, *sao_aux, *sao_off; /* (3,nctu), (3,nctu,4) */
    const int32_t *qp_map;   /* per-CTU target QP or NULL */
    long *tok_off, *lev_off; /* per-CTB cursors (prepass) */
} QuadW;

typedef struct { int prev; int coded; int target; } QpChain;

static int qw_scan(int intra_mode, int log2, int c_idx) {
    /* 7.4.9.11: mode-dependent scan for small intra TBs */
    if (intra_mode >= 0 && (log2 == 2 || (log2 == 3 && c_idx == 0))) {
        if (intra_mode >= 6 && intra_mode <= 14) return 2;  /* vert */
        if (intra_mode >= 22 && intra_mode <= 30) return 1; /* horiz */
    }
    return 0;
}

static void qw_qp_tu(CabacEnc *e, QpChain *qc, int any_cbf) {
    if (!qc || qc->coded || !any_cbf) return;
    qc->coded = 1;
    int delta = qc->target - qc->prev;
    int a = delta < 0 ? -delta : delta;
    int pref = a < 5 ? a : 5;
    for (int b = 0; b < pref; b++)
        enc_bin(e, CTX_CU_QP_DELTA_ABS + (b ? 1 : 0), 1);
    if (pref < 5) enc_bin(e, CTX_CU_QP_DELTA_ABS + (pref ? 1 : 0), 0);
    else enc_egk(e, (uint32_t)(a - 5), 0);
    if (a) enc_bypass(e, delta < 0);
    qc->prev = qc->target;
}

static int qw_sao_same(const QuadW *q, long i, long j) {
    long n = (long)q->cw * q->chh;
    for (int c = 0; c < 3; c++) {
        if (q->sao_typ[c * n + i] != q->sao_typ[c * n + j]) return 0;
        if (q->sao_aux[c * n + i] != q->sao_aux[c * n + j]) return 0;
        for (int k = 0; k < 4; k++)
            if (q->sao_off[(c * n + i) * 4 + k] != q->sao_off[(c * n + j) * 4 + k])
                return 0;
    }
    return 1;
}

static void qw_sao_params(CabacEnc *e, const QuadW *q, long i) {
    long n = (long)q->cw * q->chh;
    for (int c = 0; c < 3; c++) {
        int t = q->sao_typ[c * n + i];
        if (c != 2) { /* type coded for luma and once for chroma */
            enc_bin(e, CTX_SAO_TYPE_IDX, t != 0);
            if (t) enc_bypass(e, t == 2);
        }
        if (t == 0) continue;
        const int32_t *off = q->sao_off + (c * n + i) * 4;
        for (int k = 0; k < 4; k++) {
            int a = off[k] < 0 ? -off[k] : off[k];
            for (int b = 0; b < a; b++) enc_bypass(e, 1);
            if (a < 7) enc_bypass(e, 0);
        }
        if (t == 1) { /* band: signs + position */
            for (int k = 0; k < 4; k++)
                if (off[k]) enc_bypass(e, off[k] < 0);
            enc_bypass_bits(e, (uint32_t)q->sao_aux[c * n + i], 5);
        } else if (c != 2) {
            enc_bypass_bits(e, (uint32_t)q->sao_aux[c * n + i], 2);
        }
    }
}

static void qw_sao(CabacEnc *e, const QuadW *q, long i) {
    if (!q->sao_typ) return;
    int c = (int)(i % q->cw), r = (int)(i / q->cw);
    int merge_left = c > 0 && qw_sao_same(q, i, i - 1);
    if (c > 0) enc_bin(e, CTX_SAO_MERGE_FLAG, merge_left);
    if (merge_left) return;
    int merge_up = r > 0 && qw_sao_same(q, i, i - q->cw);
    if (r > 0) enc_bin(e, CTX_SAO_MERGE_FLAG, merge_up);
    if (!merge_up) qw_sao_params(e, q, i);
}

/* MPM b-candidate: DC unless the above 4x4 is in the same CTB row */
static int qw_cand_b(const QuadW *q, int x0, int y0) {
    int cl = 1 << q->ctb_log2;
    if (y0 == 0 || ((y0 - 1) / cl) != (y0 / cl)) return 1;
    return q->mode4[(long)((y0 - 1) >> 2) * q->w4 + (x0 >> 2)];
}

static int qw_cand_a(const QuadW *q, int x0, int y0) {
    if (x0 == 0) return 1;
    return q->mode4[(long)(y0 >> 2) * q->w4 + ((x0 - 1) >> 2)];
}

static void enc_luma_mode_tail(CabacEnc *e, int mode, int a, int b, int in_mpm) {
    int mpm[3];
    mpm_list(a, b, mpm);
    if (in_mpm) {
        int idx = 0;
        for (int i = 0; i < 3; i++) if (mpm[i] == mode) { idx = i; break; }
        enc_bypass(e, idx ? 1 : 0);
        if (idx) enc_bypass(e, idx - 1);
    } else {
        int s[3] = {mpm[0], mpm[1], mpm[2]};
        for (int i = 0; i < 2; i++)
            for (int j = i + 1; j < 3; j++)
                if (s[j] > s[i]) { int t = s[i]; s[i] = s[j]; s[j] = t; }
        int rem = mode;
        for (int i = 0; i < 3; i++) if (mode > s[i]) rem--;
        enc_bypass_bits(e, (uint32_t)rem, 5);
    }
}

static int qw_in_mpm(int mode, int a, int b) {
    int mpm[3];
    mpm_list(a, b, mpm);
    for (int i = 0; i < 3; i++) if (mpm[i] == mode) return 1;
    return 0;
}

static int qw_any(const int32_t *p, long n) {
    for (long k = 0; k < n; k++) if (p[k]) return 1;
    return 0;
}

/* extract a sub-rectangle of a raster block into tmp */
static void qw_sub(const int32_t *src, int stride, int x, int y, int n, int32_t *dst) {
    for (int r = 0; r < n; r++)
        memcpy(dst + (long)r * n, src + (long)(y + r) * stride + x, sizeof(int32_t) * n);
}

static const int QW_ZO[4][2] = {{0, 0}, {0, 1}, {1, 0}, {1, 1}}; /* (dy,dx) */

/* intra coding_unit body (shared by I slices and P ct==0), cursor-based */
static void qw_intra_cu(CabacEnc *e, QuadW *q, long *tp, long *lp,
                        int x0, int y0, int log2, QpChain *qc) {
    int n = 1 << log2;
    int nxn = q->toks[(*tp)++];
    int modes[4];
    if (log2 == q->min_cb_log2) enc_bin(e, CTX_PART_MODE, !nxn);
    if (nxn) for (int j = 0; j < 4; j++) modes[j] = q->toks[(*tp)++];
    else modes[0] = q->toks[(*tp)++];
    int tsplit = q->toks[(*tp)++];
    if (!nxn) {
        enc_luma_mode(e, modes[0], qw_cand_a(q, x0, y0), qw_cand_b(q, x0, y0));
    } else {
        int h = n >> 1;
        int cands[4][2], flags[4];
        for (int j = 0; j < 4; j++) {
            int xj = x0 + QW_ZO[j][1] * h, yj = y0 + QW_ZO[j][0] * h;
            cands[j][0] = qw_cand_a(q, xj, yj);
            cands[j][1] = qw_cand_b(q, xj, yj);
            flags[j] = qw_in_mpm(modes[j], cands[j][0], cands[j][1]);
        }
        for (int j = 0; j < 4; j++)
            enc_bin(e, CTX_PREV_INTRA_LUMA_PRED_FLAG, flags[j]);
        for (int j = 0; j < 4; j++)
            enc_luma_mode_tail(e, modes[j], cands[j][0], cands[j][1], flags[j]);
    }
    enc_bin(e, CTX_INTRA_CHROMA_PRED_MODE, 0); /* DM chroma */
    long ylen = (long)n * n, clen = (long)(n / 2) * (n / 2);
    const int32_t *ly = q->levs + *lp;
    const int32_t *lcb = ly + ylen;
    const int32_t *lcr = lcb + clen;
    *lp += ylen + 2 * clen;
    if (log2 <= 5 && log2 > 2 && q->td_intra > 0 && !nxn)
        enc_bin(e, CTX_SPLIT_TRANSFORM_FLAG + 5 - log2, tsplit);
    int cbf_cb = qw_any(lcb, clen), cbf_cr = qw_any(lcr, clen);
    enc_bin(e, CTX_CBF_CHROMA, cbf_cb);
    enc_bin(e, CTX_CBF_CHROMA, cbf_cr);
    int32_t tmp[32 * 32];
    if (tsplit || log2 == 6) {
        /* trafoDepth-1 children: tsplit quarters (CU16/CU32) or the CU64
         * forced TT (four TU32s); per-child chroma cbfs + residuals */
        int m = modes[0];
        int hn = n >> 1, qn = hn >> 1;
        for (int j = 0; j < 4; j++) {
            int dy = QW_ZO[j][0], dx = QW_ZO[j][1];
            int32_t tcb[16 * 16], tcr[16 * 16];
            qw_sub(lcb, n / 2, dx * qn, dy * qn, qn, tcb);
            qw_sub(lcr, n / 2, dx * qn, dy * qn, qn, tcr);
            int c_cb = qw_any(tcb, (long)qn * qn);
            int c_cr = qw_any(tcr, (long)qn * qn);
            if (cbf_cb) enc_bin(e, CTX_CBF_CHROMA + 1, c_cb);
            if (cbf_cr) enc_bin(e, CTX_CBF_CHROMA + 1, c_cr);
            qw_sub(ly, n, dx * hn, dy * hn, hn, tmp);
            int c_y = qw_any(tmp, (long)hn * hn);
            enc_bin(e, CTX_CBF_LUMA, c_y); /* trafoDepth 1 */
            qw_qp_tu(e, qc, c_y || c_cb || c_cr);
            if (c_y) encode_residual(e, tmp, log2 - 1, 0, qw_scan(m, log2 - 1, 0));
            if (c_cb) encode_residual(e, tcb, log2 - 2, 1, qw_scan(m, log2 - 2, 1));
            if (c_cr) encode_residual(e, tcr, log2 - 2, 2, qw_scan(m, log2 - 2, 2));
        }
        return;
    }
    if (!nxn) {
        int cbf_y = qw_any(ly, ylen);
        enc_bin(e, CTX_CBF_LUMA + 1, cbf_y);
        qw_qp_tu(e, qc, cbf_y || cbf_cb || cbf_cr);
        if (cbf_y) encode_residual(e, ly, log2, 0, qw_scan(modes[0], log2, 0));
        if (cbf_cb) encode_residual(e, lcb, log2 - 1, 1, qw_scan(modes[0], log2 - 1, 1));
        if (cbf_cr) encode_residual(e, lcr, log2 - 1, 2, qw_scan(modes[0], log2 - 1, 2));
        return;
    }
    /* NxN: four quarter luma TUs at trafoDepth 1, chroma at parent size */
    int hn = n >> 1;
    for (int j = 0; j < 4; j++) {
        int dy = QW_ZO[j][0], dx = QW_ZO[j][1];
        qw_sub(ly, n, dx * hn, dy * hn, hn, tmp);
        int cbf_t = qw_any(tmp, (long)hn * hn);
        enc_bin(e, CTX_CBF_LUMA, cbf_t); /* trafoDepth 1 */
        /* 4x4 children: chroma rides the last child (7.3.8.10 last4) */
        qw_qp_tu(e, qc, cbf_t || (j == 3 && (cbf_cb || cbf_cr)));
        if (cbf_t) encode_residual(e, tmp, log2 - 1, 0, qw_scan(modes[j], log2 - 1, 0));
    }
    int dm = modes[0];
    if (cbf_cb) encode_residual(e, lcb, log2 - 1, 1, qw_scan(dm, log2 - 1, 1));
    if (cbf_cr) encode_residual(e, lcr, log2 - 1, 2, qw_scan(dm, log2 - 1, 2));
}

/* P-slice coding unit (inter leaves + intra via qw_intra_cu) */
static void qw_p_cu(CabacEnc *e, QuadW *q, long *tp, long *lp,
                    int x0, int y0, int log2, QpChain *qc) {
    int n = 1 << log2;
    int ct = q->toks[(*tp)++];
    int ctx = 0;
    if (x0 > 0 && q->skip4[(long)(y0 >> 2) * q->w4 + ((x0 - 1) >> 2)]) ctx++;
    if (y0 > 0 && q->skip4[(long)((y0 - 1) >> 2) * q->w4 + (x0 >> 2)]) ctx++;
    /* NOTE: skip4 is precomputed for the whole picture; the ctx must see
     * the PRE-scan state, which equals the precomputed value because skip
     * regions never overlap and left/up reads are scan-past positions. */
    int is_skip = ct == CT_SKIP;
    enc_bin(e, CTX_CU_SKIP_FLAG + ctx, is_skip);
    if (is_skip) {
        enc_merge_idx(e, q->toks[(*tp)++], q->merge_k);
        *lp += (long)n * n + 2 * (long)(n / 2) * (n / 2); /* zero levels */
        return;
    }
    enc_bin(e, CTX_PRED_MODE_FLAG, ct == CT_INTRA);
    if (ct == CT_INTRA) {
        qw_intra_cu(e, q, tp, lp, x0, y0, log2, qc);
        return;
    }
    enc_bin(e, CTX_PART_MODE, 1); /* PART_2Nx2N */
    enc_bin(e, CTX_MERGE_FLAG, ct == CT_MERGE);
    if (ct == CT_MERGE) {
        enc_merge_idx(e, q->toks[(*tp)++], q->merge_k);
    } else if (q->slice_type == 0) {
        /* B AMVP PU: inter_pred_idc (9.3.3.10 — 2Nx2N uses the CtDepth
         * ctx for the bi/uni bin, ctx 4 for the list bin), then per-list
         * mvd + mvp_flag (one ref per list: ref_idx absent) */
        int dr = q->toks[(*tp)++];
        enc_bin(e, CTX_INTER_PRED_IDC + (q->ctb_log2 - log2), dr == 3);
        if (dr != 3) enc_bin(e, CTX_INTER_PRED_IDC + 4, dr == 2);
        for (int l = 0; l < 2; l++) {
            if (!(dr & (1 << l))) continue;
            int mvd_x = q->toks[(*tp)++], mvd_y = q->toks[(*tp)++];
            int mvp = q->toks[(*tp)++];
            enc_mvd(e, mvd_x, mvd_y);
            enc_bin(e, CTX_MVP_FLAG, mvp);
        }
    } else {
        int mvd_x = q->toks[(*tp)++], mvd_y = q->toks[(*tp)++];
        int mvp = q->toks[(*tp)++];
        enc_mvd(e, mvd_x, mvd_y);
        enc_bin(e, CTX_MVP_FLAG, mvp);
    }
    long ylen = (long)n * n, clen = (long)(n / 2) * (n / 2);
    const int32_t *ly = q->levs + *lp;
    const int32_t *lcb = ly + ylen;
    const int32_t *lcr = lcb + clen;
    *lp += ylen + 2 * clen;
    int cbf_y = qw_any(ly, ylen);
    int cbf_cb = qw_any(lcb, clen), cbf_cr = qw_any(lcr, clen);
    int root = cbf_y || cbf_cb || cbf_cr;
    if (ct == CT_AMVP) {
        enc_bin(e, CTX_RQT_ROOT_CBF, root);
        if (!root) return;
    }
    if (log2 == 6) {
        /* inter CU64: forced TT to four TU32s (7.3.8.8) */
        enc_bin(e, CTX_CBF_CHROMA, cbf_cb);
        enc_bin(e, CTX_CBF_CHROMA, cbf_cr);
        int32_t tmp[32 * 32];
        for (int j = 0; j < 4; j++) {
            int dy = QW_ZO[j][0], dx = QW_ZO[j][1];
            int32_t tcb[16 * 16], tcr[16 * 16];
            qw_sub(lcb, 32, dx * 16, dy * 16, 16, tcb);
            qw_sub(lcr, 32, dx * 16, dy * 16, 16, tcr);
            int c_cb = qw_any(tcb, 256), c_cr = qw_any(tcr, 256);
            if (cbf_cb) enc_bin(e, CTX_CBF_CHROMA + 1, c_cb);
            if (cbf_cr) enc_bin(e, CTX_CBF_CHROMA + 1, c_cr);
            qw_sub(ly, 64, dx * 32, dy * 32, 32, tmp);
            int c_y = qw_any(tmp, 1024);
            enc_bin(e, CTX_CBF_LUMA, c_y); /* trafoDepth 1 */
            qw_qp_tu(e, qc, c_y || c_cb || c_cr);
            if (c_y) encode_residual(e, tmp, 5, 0, 0);
            if (c_cb) encode_residual(e, tcb, 4, 1, 0);
            if (c_cr) encode_residual(e, tcr, 4, 2, 0);
        }
        return;
    }
    /* TU == CU at depth 0 */
    enc_bin(e, CTX_CBF_CHROMA, cbf_cb);
    enc_bin(e, CTX_CBF_CHROMA, cbf_cr);
    if (cbf_cb || cbf_cr) enc_bin(e, CTX_CBF_LUMA + 1, cbf_y);
    /* else cbf_luma inferred 1 */
    qw_qp_tu(e, qc, cbf_y || cbf_cb || cbf_cr);
    if (cbf_y) encode_residual(e, ly, log2, 0, 0);
    if (cbf_cb) encode_residual(e, lcb, log2 - 1, 1, 0);
    if (cbf_cr) encode_residual(e, lcr, log2 - 1, 2, 0);
}

static void qw_quadtree(CabacEnc *e, QuadW *q, long *tp, long *lp,
                        int x0, int y0, int log2, int depth, QpChain *qc) {
    int split = 0;
    if (log2 > q->min_cb_log2) {
        split = q->toks[(*tp)++];
        int ctx = 0;
        if (x0 > 0 && q->depth4[(long)(y0 >> 2) * q->w4 + ((x0 - 1) >> 2)] > depth) ctx++;
        if (y0 > 0 && q->depth4[(long)((y0 - 1) >> 2) * q->w4 + (x0 >> 2)] > depth) ctx++;
        enc_bin(e, CTX_SPLIT_CU_FLAG + ctx, split);
    }
    if (split) {
        int h = 1 << (log2 - 1);
        for (int j = 0; j < 4; j++)
            qw_quadtree(e, q, tp, lp, x0 + QW_ZO[j][1] * h,
                        y0 + QW_ZO[j][0] * h, log2 - 1, depth + 1, qc);
        return;
    }
    if (q->slice_type != 2) qw_p_cu(e, q, tp, lp, x0, y0, log2, qc);
    else qw_intra_cu(e, q, tp, lp, x0, y0, log2, qc);
}

/* ---- prepass: token/level cursors per CTB + depth4/mode4/skip4 maps.
 * Reads during entropy are always of scan-past positions, so the final
 * maps equal the incrementally-written ones at every read site. */
static void qw_pre_node(QuadW *q, long *tp, long *lp, int x0, int y0,
                        int log2, int depth) {
    int split = 0;
    if (log2 > q->min_cb_log2) split = q->toks[(*tp)++];
    if (split) {
        int h = 1 << (log2 - 1);
        for (int j = 0; j < 4; j++)
            qw_pre_node(q, tp, lp, x0 + QW_ZO[j][1] * h,
                        y0 + QW_ZO[j][0] * h, log2 - 1, depth + 1);
        return;
    }
    int n = 1 << log2;
    for (int yy = y0 >> 2; yy < (y0 + n) >> 2; yy++)
        for (int xx = x0 >> 2; xx < (x0 + n) >> 2; xx++)
            q->depth4[(long)yy * q->w4 + xx] = (int8_t)depth;
    int ct = 0;
    if (q->slice_type != 2) {
        ct = q->toks[(*tp)++];
        for (int yy = y0 >> 2; yy < (y0 + n) >> 2; yy++)
            for (int xx = x0 >> 2; xx < (x0 + n) >> 2; xx++)
                q->skip4[(long)yy * q->w4 + xx] = ct == CT_SKIP;
        if (ct == CT_SKIP || ct == CT_MERGE) (*tp)++;
        else if (ct == CT_AMVP) {
            if (q->slice_type == 0) { /* [inter_dir] + 3 per active list */
                int dr = q->toks[(*tp)++];
                (*tp) += 3 * ((dr & 1) + ((dr >> 1) & 1));
            } else (*tp) += 3;
        }
        if (ct != CT_INTRA) {
            *lp += (long)n * n + 2 * (long)(n / 2) * (n / 2);
            return;
        }
    }
    int nxn = q->toks[(*tp)++];
    if (nxn) {
        int h = n >> 1;
        for (int j = 0; j < 4; j++) {
            int m = q->toks[(*tp)++];
            int xj = x0 + QW_ZO[j][1] * h, yj = y0 + QW_ZO[j][0] * h;
            for (int yy = yj >> 2; yy < (yj + h) >> 2; yy++)
                for (int xx = xj >> 2; xx < (xj + h) >> 2; xx++)
                    q->mode4[(long)yy * q->w4 + xx] = m;
        }
    } else {
        int m = q->toks[(*tp)++];
        for (int yy = y0 >> 2; yy < (y0 + n) >> 2; yy++)
            for (int xx = x0 >> 2; xx < (x0 + n) >> 2; xx++)
                q->mode4[(long)yy * q->w4 + xx] = m;
    }
    (*tp)++; /* tsplit */
    *lp += (long)n * n + 2 * (long)(n / 2) * (n / 2);
}

/* ---- WPP row threads (context inheritance like encode_row_thread) */
typedef struct QRowCtl {
    QuadW *q;
    int slice_qp;
    int row;
    uint8_t *out;
    long cap;
    long len;
    uint8_t ctx_after1_state[NUM_CONTEXTS];
    uint8_t ctx_after1_mps[NUM_CONTEXTS];
    int ctx_after1_ready;
    pthread_mutex_t mu;
    pthread_cond_t cv;
    struct QRowCtl *prev;
    int error;
} QRowCtl;

static void qw_ctu(CabacEnc *e, QuadW *q, long i, QpChain *qc) {
    qw_sao(e, q, i);
    if (qc) { qc->coded = 0; qc->target = q->qp_map[i]; }
    long tp = q->tok_off[i], lp = q->lev_off[i];
    int n = 1 << q->ctb_log2;
    qw_quadtree(e, q, &tp, &lp, (int)(i % q->cw) * n, (int)(i / q->cw) * n,
                q->ctb_log2, 0, qc);
}

static void *qw_row_thread(void *arg) {
    QRowCtl *rc = (QRowCtl *)arg;
    QuadW *q = rc->q;
    int cw = q->cw, chh = q->chh;
    long nctu = (long)cw * chh;
    CabacEnc e;
    enc_init(&e, q->slice_type == 2 ? 0 : (q->slice_type == 1 ? 1 : 2),
             rc->slice_qp, rc->out, rc->cap);
    if (rc->row > 0 && cw > 1) {
        QRowCtl *prev = rc->prev;
        pthread_mutex_lock(&prev->mu);
        while (!prev->ctx_after1_ready) pthread_cond_wait(&prev->cv, &prev->mu);
        pthread_mutex_unlock(&prev->mu);
        memcpy(e.state, prev->ctx_after1_state, NUM_CONTEXTS);
        memcpy(e.mps, prev->ctx_after1_mps, NUM_CONTEXTS);
    }
    QpChain qc0 = {rc->slice_qp, 0, 0};
    QpChain *qc = q->qp_map ? &qc0 : NULL;
    for (int c = 0; c < cw; c++) {
        long i = (long)rc->row * cw + c;
        qw_ctu(&e, q, i, qc);
        if (c == 1) {
            pthread_mutex_lock(&rc->mu);
            memcpy(rc->ctx_after1_state, e.state, NUM_CONTEXTS);
            memcpy(rc->ctx_after1_mps, e.mps, NUM_CONTEXTS);
            rc->ctx_after1_ready = 1;
            pthread_cond_signal(&rc->cv);
            pthread_mutex_unlock(&rc->mu);
        }
        int last = i == nctu - 1;
        enc_terminate(&e, last);
        if (!last && c == cw - 1) enc_terminate(&e, 1); /* end_of_subset */
    }
    if (cw == 1) {
        pthread_mutex_lock(&rc->mu);
        rc->ctx_after1_ready = 1;
        pthread_cond_signal(&rc->cv);
        pthread_mutex_unlock(&rc->mu);
    }
    while (e.out.nbits & 7) put_bit_raw(&e.out, 0);
    rc->len = e.out.error ? -1 : (e.out.nbits >> 3);
    rc->error = e.out.error;
    return NULL;
}

long encode_slice_quad_c(
    int slice_type, int wpp,
    const int32_t *tokens, const int32_t *levels,
    int ctbs_w, int ctbs_h, int ctb_log2, int min_cb_log2, int td_intra,
    int slice_qp, int merge_k,
    const int32_t *sao_typ, const int32_t *sao_aux, const int32_t *sao_off,
    const int32_t *qp_map,
    uint8_t *out, long out_cap, long *row_lens) {
    long nctu = (long)ctbs_w * ctbs_h;
    int w4 = (ctbs_w << ctb_log2) >> 2, h4 = (ctbs_h << ctb_log2) >> 2;
    QuadW q = {tokens, levels, ctbs_w, ctbs_h, ctb_log2, min_cb_log2,
               td_intra, slice_type, merge_k ? merge_k : 1, w4, h4,
               NULL, NULL, NULL, sao_typ, sao_aux, sao_off, qp_map,
               NULL, NULL};
    q.depth4 = (int8_t *)calloc((size_t)w4 * h4, 1);
    q.mode4 = (int32_t *)malloc(sizeof(int32_t) * (size_t)w4 * h4);
    q.skip4 = (uint8_t *)calloc((size_t)w4 * h4, 1);
    q.tok_off = (long *)malloc(sizeof(long) * (nctu + 1));
    q.lev_off = (long *)malloc(sizeof(long) * (nctu + 1));
    for (long k = 0; k < (long)w4 * h4; k++) q.mode4[k] = 1; /* DC init */
    long tp = 0, lp = 0;
    int n = 1 << ctb_log2;
    for (long i = 0; i < nctu; i++) {
        q.tok_off[i] = tp;
        q.lev_off[i] = lp;
        qw_pre_node(&q, &tp, &lp, (int)(i % ctbs_w) * n, (int)(i / ctbs_w) * n,
                    ctb_log2, 0);
    }
    long total = -1;
    if (!wpp) {
        CabacEnc e;
        enc_init(&e, slice_type == 2 ? 0 : (slice_type == 1 ? 1 : 2),
                 slice_qp, out, out_cap);
        QpChain qc0 = {slice_qp, 0, 0};
        QpChain *qc = qp_map ? &qc0 : NULL;
        for (long i = 0; i < nctu; i++) {
            qw_ctu(&e, &q, i, qc);
            enc_terminate(&e, i == nctu - 1);
            if (e.out.error) goto qdone;
        }
        while (e.out.nbits & 7) put_bit_raw(&e.out, 0);
        row_lens[0] = e.out.nbits >> 3;
        total = row_lens[0];
        goto qdone;
    }
    {
        long per_cap = out_cap / ctbs_h;
        uint8_t *tmp = (uint8_t *)malloc((size_t)out_cap);
        QRowCtl *rows = (QRowCtl *)calloc(ctbs_h, sizeof(QRowCtl));
        pthread_t *tids = (pthread_t *)malloc(sizeof(pthread_t) * ctbs_h);
        for (int r = 0; r < ctbs_h; r++) {
            rows[r].q = &q;
            rows[r].slice_qp = slice_qp;
            rows[r].row = r;
            rows[r].out = tmp + (long)r * per_cap;
            rows[r].cap = per_cap;
            pthread_mutex_init(&rows[r].mu, NULL);
            pthread_cond_init(&rows[r].cv, NULL);
            rows[r].prev = r > 0 ? &rows[r - 1] : NULL;
        }
        int started = 0;
        for (int r = 0; r < ctbs_h; r++) {
            if (pthread_create(&tids[r], NULL, qw_row_thread, &rows[r]) != 0)
                break;  /* thread limit: finish the rest inline below */
            started++;
        }
        for (int r = started; r < ctbs_h; r++) qw_row_thread(&rows[r]);
        int err = 0;
        for (int r = 0; r < ctbs_h; r++) {
            if (r < started) pthread_join(tids[r], NULL);
            if (rows[r].error || rows[r].len < 0) err = 1;
        }
        if (!err) {
            long pos = 0;
            for (int r = 0; r < ctbs_h; r++) {
                memcpy(out + pos, rows[r].out, rows[r].len);
                row_lens[r] = rows[r].len;
                pos += rows[r].len;
            }
            total = pos;
        }
        for (int r = 0; r < ctbs_h; r++) {
            pthread_mutex_destroy(&rows[r].mu);
            pthread_cond_destroy(&rows[r].cv);
        }
        free(tids);
        free(rows);
        free(tmp);
    }
qdone:
    free(q.depth4);
    free(q.mode4);
    free(q.skip4);
    free(q.tok_off);
    free(q.lev_off);
    return total;
}
