"""Shared constants of the alignment engine.

Values mirror the reference's observable behavior (cited per constant) but
are surfaced here in one typed place instead of being scattered hardcoded
literals (reference: Align_src/aln.h:121-151, alnse.c:42,1016,1079).
"""

# --- Nucleotide codes (Align_src/variant.c:23-40 nst_nt4_table) ---
NT_A, NT_C, NT_G, NT_T, NT_N = 0, 1, 2, 3, 4
# R-part 5-letter alphabet adds '#' (Align_src/rbwt.h:40-45)
NT_SHARP = 4
# Sentinel codes used by our own symbol arrays (not on-disk formats of the
# reference; ours keep the sentinel in-band as its own symbol).
C_SENTINEL = 4          # C-part BWT symbol array: 0..3 bases, 4 = '$'
R_SENTINEL = 5          # R-part BWT symbol array: 0..4 text chars, 5 = '$'

# one-hot encoding of a base (A=1,C=2,G=4,T=8, N=15) used by the mixRef
# nibble match test (Align_src/editdistance.c:40)
NT2BIT = (1, 2, 4, 8, 15)

# --- Index build (Index_src/index1.c:44-45, localPattern.c:26) ---
MAX_LOOKUP_LEN = 12     # 12-mer lookup table
C_SA_INTV = 8           # reference C-part SA sampling (ours stores full SA)
WIN_MAX_SNP_NUM = 5     # max SNPs enumerated per local-pattern window
DEFAULT_L_SEED = 25     # salt-idx -k default (Index_src/index1.c:49)
BNS_RANDOM_SEED = 11    # N -> random base seed (Index_src/bntseq.c:178)

# --- Alignment defaults (Align_src/aln.c:28-56, aln.h:121-151) ---
DEFAULT_MAX_SEED = 50       # max occ per seed before greedy left-extension
DEFAULT_MAX_LOCATE = 1000   # per-strand cap on located candidate positions
DEFAULT_MAX_HITS = 5        # aln_opt->max_hits hardcodes 5 (aln.h:133)
MAX_LOC_POS = 0x40000       # global locate cap of alnse_locate (alnse.c:42)
NOGAP_MAX_DIFF = 3          # hardcoded ungapped threshold (alnse.c:1016,1079)
LV_MAX_K = 31               # Landau-Vishkin band limit (LandauVishkin.c:13)
GAP_WINDOW_PAD = 4          # gapped verify ref window = l_seq+4 (alnse.c:373)
SE_MAX_N_AMBIGUOUS = 200    # SE: skip read if > 200 Ns (alnse.c:1281)
PE_MAX_N_AMBIGUOUS = 5      # PE: skip read if > 5 Ns (alnpe.c:481)

# PE defaults (aln.c:43-44, aln.h:137-144)
DEFAULT_MIN_TLEN = 250
DEFAULT_MAX_TLEN = 550
SW_GAP_OPEN = 3
SW_GAP_EXTEND = 1
SW_FILTER_SCORE = 0      # aln_opt->filters (aln.h:141)
SW_FILTER_DIST = 20      # aln_opt->filterd (aln.h:142)
SW_THRES_SCORE = 50      # aln_opt->thres_score (aln.h:144)

POS_UNMAPPED = 0xFFFFFFFF
UINT32_MAX = 0xFFFFFFFF

# ASCII -> 2-bit code table (A/a=0, C/c=1, G/g=2, T/t=3, '-'=5, other=4)
# mirrors Align_src/variant.c:23-40.
import numpy as np

NST_NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    NST_NT4_TABLE[ord(_ch)] = _code
    NST_NT4_TABLE[ord(_ch.lower())] = _code
NST_NT4_TABLE[ord("-")] = 5

# mixRef FASTA char -> one-hot nibble (A=1,C=2,G=4,T=8, everything else 0)
# mirrors Align_src/metaref.c:36-53 nt5_4bit_table.
NT5_4BIT_TABLE = np.zeros(256, dtype=np.uint8)
for _ch, _bit in (("A", 1), ("C", 2), ("G", 4), ("T", 8)):
    NT5_4BIT_TABLE[ord(_ch)] = _bit
    NT5_4BIT_TABLE[ord(_ch.lower())] = _bit
