// Address/UB-sanitizer driver over the native IO/pileup layer.
//
// The reference wraps every test invocation in valgrind
// (build-common/python/valgrindwrapper.py:25-48) so each run is also a
// leak/memory-safety check.  This driver is the analog for this
// implementation's C++ layer: tests/test_native.py compiles it with
// sniper_native.cpp under -fsanitize=address,undefined and runs it over
// the golden BAM pair; any leak, overflow, or UB fails the exit code.
//
// Usage: asan_driver <tumor.bam> <normal.bam>

#include "../../somatic_sniper_tpu/io/native/sniper_native.cpp"

#include <cstdio>
#include <cstdlib>
#include <vector>

int main(int argc, char** argv) {
    if (argc < 3) {
        std::fprintf(stderr, "usage: %s tumor.bam normal.bam\n", argv[0]);
        return 2;
    }
    NativeBam* bt = bam_load(argv[1], 2);
    NativeBam* bn = bam_load(argv[2], 1);
    if (!bt || !bn) {
        std::fprintf(stderr, "load failed: %s\n", sniper_last_error());
        return 1;
    }
    NativePileup* pt = pileup_build(bt, 1796, 0);
    NativePileup* pn = pileup_build(bn, 1796, 0);
    if (!pt || !pn) return 1;

    // a fake all-A reference long enough for the test contigs
    int64_t maxlen = 0;
    for (int32_t i = 0; i < bt->n_ref; ++i)
        if (bt->ref_len[i] > maxlen) maxlen = bt->ref_len[i];
    std::vector<uint8_t> ref16((size_t)(maxlen * bt->n_ref), 1);
    std::vector<int64_t> ref_off(bt->n_ref + 1, 0);
    for (int32_t i = 0; i < bt->n_ref; ++i)
        ref_off[i + 1] = ref_off[i] + maxlen;

    std::vector<double> fk(256, 1.0), gmin(256, 0.0);
    std::vector<uint8_t> flags(pt->n_cols);
    pileup_flags(pt, ref16.data(), ref_off.data(), bt->n_ref, fk.data(),
                 gmin.data(), 2.0, flags.data());

    // dense + compact padding over the first (up to) 64 columns
    int64_t B = pt->n_cols < 64 ? pt->n_cols : 64;
    std::vector<int64_t> ci(B);
    for (int64_t i = 0; i < B; ++i) ci[i] = i;
    std::vector<uint32_t> out32(B * 32);
    pileup_pad(pt, ci.data(), B, 32, out32.data());
    std::vector<int32_t> r16(B, 1), nk(B), rms(B);
    std::vector<uint16_t> out16(B * 32);
    pileup_pad16(pt, ci.data(), r16.data(), B, 32, 60, out16.data(),
                 nk.data(), rms.data());

    // fused paired plan with the exact dual-consensus tier (synthetic
    // coef/lhet tables: values only need to be readable, not realistic)
    int32_t buckets[4] = {16, 32, 64, 128};
    int64_t cap = pt->n_cols < pn->n_cols ? pt->n_cols : pn->n_cols;
    std::vector<int64_t> keys(cap), ti(cap), ni(cap), goff(6);
    std::vector<int32_t> dt(cap), dn(cap), rr(cap);
    std::vector<double> coef((size_t)64 * 256 * 256, 1.0);
    std::vector<double> lhet((size_t)256 * 256, -0.5);
    int64_t total = paired_plan(
        pt, pn, ref16.data(), ref_off.data(), bt->n_ref, fk.data(),
        gmin.data(), 2.0, 1, coef.data(), lhet.data(), 30, 1,
        buckets, 4, keys.data(), ti.data(), ni.data(),
        dt.data(), dn.data(), rr.data(), goff.data());

    // fused dual-sample slab fill (round-4 fast-path entrypoint)
    {
        int64_t Bp = pt->n_cols < pn->n_cols ? pt->n_cols : pn->n_cols;
        if (Bp > 48) Bp = 48;
        std::vector<int64_t> tix(Bp), nix(Bp);
        for (int64_t i = 0; i < Bp; ++i) tix[i] = nix[i] = i;
        std::vector<int32_t> rf(Bp, 1), dts(Bp, 3), dns(Bp, 3);
        std::vector<uint16_t> st(Bp * 32), sn(Bp * 32);
        std::vector<int32_t> m0(Bp), m1(Bp), m2(Bp);
        slab_fill_pair(pt, pn, tix.data(), nix.data(), rf.data(),
                       dts.data(), dns.data(), Bp, 32, 60, st.data(),
                       sn.data(), m0.data(), m1.data(), m2.data());
    }

    // exact consensus debug surface over the padded columns
    std::vector<int32_t> cns(B), keep(B);
    glf_cns_batch(pt, ci.data(), B, r16.data(), coef.data(), lhet.data(),
                  fk.data(), 30, cns.data(), keep.data());

    // per-site depth/quality stats over the same columns
    std::vector<int32_t> rb4(B, 1), wanted(B, 0xF), dq(B * 18);
    pileup_dqstats(pt, ci.data(), B, rb4.data(), wanted.data(), dq.data());

    // fused load path (header-only read + pileup straight off the
    // record bytes) must agree with the two-phase build above
    NativeBamHeader* hd = bam_read_header(argv[1]);
    if (!hd || hd->n_ref != bt->n_ref) {
        std::fprintf(stderr, "bam_read_header mismatch\n");
        return 1;
    }
    NativePileup* pf = bam_load_pileup(argv[1], 2, 1796, 0, ref16.data(),
                                       ref_off.data(), bt->n_ref,
                                       fk.data(), gmin.data(), 2.0);
    if (!pf || pf->n_cols != pt->n_cols || pf->n_entries != pt->n_entries) {
        std::fprintf(stderr, "bam_load_pileup mismatch\n");
        return 1;
    }
    for (int64_t c = 0; c <= pf->n_cols; ++c)
        if (pf->offsets[c] != pt->offsets[c]) {
            std::fprintf(stderr, "fused offsets diverge at %lld\n",
                         (long long)c);
            return 1;
        }
    for (int64_t i = 0; i < pf->n_entries; ++i)
        if (pf->slots[i] != pt->slots[i]) {
            std::fprintf(stderr, "fused slots diverge at %lld\n",
                         (long long)i);
            return 1;
        }
    pileup_destroy(pf);
    bam_header_destroy(hd);

    // full native exact scorer + near-pure proof over the paired plan
    if (total > 0) {
        std::vector<int32_t> qadd(1024, -1);
        std::vector<int32_t> solo(16 * 10, 1), joint(16 * 100, 2);
        std::vector<int32_t> rows((size_t)total * 17);
        int64_t nr = exact_pair_rows(
            pt, pn, ti.data(), ni.data(), total, rr.data(), coef.data(),
            lhet.data(), fk.data(), 30, qadd.data(), solo.data(),
            joint.data(), 1, 0, 1, 1, rows.data());
        std::vector<int32_t> proven(total), keepp(total);
        glf_cns_proof_batch(pt, ti.data(), total, rr.data(), coef.data(),
                            lhet.data(), fk.data(), 30, proven.data(),
                            keepp.data());
        if (nr < 0 || nr > total) {
            std::fprintf(stderr, "exact_pair_rows bad count\n");
            return 1;
        }
    }

    // bulk text emission over the first planned columns (all 3 formats,
    // incl. the buffer-too-small retry path via a deliberately tiny cap)
    if (total > 0) {
        int64_t K = total < 16 ? total : 16;
        const char names[] = "c1c2longer_name";
        int64_t name_off[4] = {0, 2, 4, 15};
        std::vector<int64_t> tids(K, 0), poss(K);
        std::vector<int32_t> chars(K, 'A'), erb(K, 1);
        std::vector<int64_t> fields((size_t)K * 12);
        std::vector<int32_t> drt((size_t)K * 18), drn((size_t)K * 18);
        for (int64_t k = 0; k < K; ++k) {
            tids[(size_t)k] = k % 3;
            poss[(size_t)k] = k * 997;
            for (int j = 0; j < 12; ++j)
                fields[(size_t)(k * 12 + j)] = (k * 7 + j * 3) % 16;
            for (int j = 0; j < 18; ++j) {
                drt[(size_t)(k * 18 + j)] = (int32_t)((k + j) % 999);
                drn[(size_t)(k * 18 + j)] = (int32_t)((k * j) % 999);
            }
        }
        std::vector<int64_t> loff(K + 1);
        for (int32_t fmtc = 0; fmtc < 3; ++fmtc) {
            int64_t small_cap = 32;  // forces the -1 grow path
            std::vector<char> tiny(small_cap);
            if (emit_lines(fmtc, K, names, name_off, tids.data(),
                           poss.data(), chars.data(), erb.data(),
                           fields.data(), 12, drt.data(), drn.data(),
                           tiny.data(), small_cap, loff.data()) != -1 &&
                K > 0) {
                std::fprintf(stderr, "emit_lines tiny-cap not refused\n");
                return 1;
            }
            int64_t cap2 = K * 1024 + 4096;
            std::vector<char> buf((size_t)cap2);
            int64_t n = emit_lines(fmtc, K, names, name_off, tids.data(),
                                   poss.data(), chars.data(), erb.data(),
                                   fields.data(), 12, drt.data(),
                                   drn.data(), buf.data(), cap2,
                                   loff.data());
            if (n < 0 || n > cap2 || loff[K] != n) {
                std::fprintf(stderr, "emit_lines bad size fmt=%d\n", fmtc);
                return 1;
            }
        }
    }

    // per-record BAI table
    NativeRecTable* rt = bam_record_table(argv[1], 2);
    if (!rt || rt->n != bt->n_reads) {
        std::fprintf(stderr, "bam_record_table mismatch\n");
        return 1;
    }
    rec_table_destroy(rt);

    std::printf("ok n_reads=%lld/%lld cols=%lld/%lld plan=%lld\n",
                (long long)bt->n_reads, (long long)bn->n_reads,
                (long long)pt->n_cols, (long long)pn->n_cols,
                (long long)total);

    pileup_destroy(pt);
    pileup_destroy(pn);
    bam_destroy(bt);
    bam_destroy(bn);
    return 0;
}
