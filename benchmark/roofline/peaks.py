"""Published peaks of one NVIDIA H100 SXM5 (80 GB HBM3), at its 700 W limit.

HBM_BYTES_PER_S: 3.35 TB/s, NVIDIA H100 Tensor Core GPU data sheet (SXM
part, "GPU memory bandwidth").

INT_MULS_PER_S: 32-bit integer multiply(-add)s a second on the CUDA cores.
The data sheet gives 67 TFLOP/s of FP32 (SXM), which is 132 SMs x 128 FP32
lanes x 2 operations (a fused multiply-add) x 1.98 GHz. The CUDA C++
Programming Guide's table of arithmetic instruction throughput gives, for
compute capability 9.0, 64 results a clock an SM for "32-bit integer
multiply, multiply-add, extended-precision multiply-add" against 128 for
FP32 fused multiply-add. So 132 x 64 x 1.98e9 = 16.75e12 multiply-adds a
second (the H100 architecture white paper's 33.5 INT32 TOPS, counting a
multiply-add as two operations).

INT_MULS_PER_FIELD_PRODUCT: a 256-bit Montgomery product over s = 8 words
of 32 bits by the CIOS method takes 2 s^2 + s = 136 word multiplications
(Koc, Acar and Kaliski, "Analyzing and comparing Montgomery multiplication
algorithms", IEEE Micro 16(3), 1996, Table 1). Each is at least one 32-bit
multiply-add instruction (a 32 x 32 -> 64-bit product is one wide
multiply-add, or a low and a high one), so 136 is a lower bound on the
instructions and the time it gives a lower bound on the product's time.

These constants are this benchmark's yardstick: none is read from the
program.
"""

HBM_BYTES_PER_S = 3.35e12

FP32_FLOPS = 67e12
FP32_FMA_PER_CLOCK_SM = 128
INT32_MUL_PER_CLOCK_SM = 64
INT_MULS_PER_S = FP32_FLOPS / 2 * INT32_MUL_PER_CLOCK_SM / FP32_FMA_PER_CLOCK_SM

MONT_WORDS = 8
INT_MULS_PER_FIELD_PRODUCT = 2 * MONT_WORDS * MONT_WORDS + MONT_WORDS
