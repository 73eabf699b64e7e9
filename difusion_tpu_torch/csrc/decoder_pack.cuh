// The packed decoder weights that kernels 1 and 3 read, in both modes: one
// flat f32 buffer, laid out by ops/decoder_fused.py:pack_fused_decoder (the
// wrappers check PACKED_SIZE and PACKED_SIZE_BF16 against it).  Offsets in
// floats.
#pragma once

namespace decoder_pack {

constexpr int LAT = 29;
constexpr int DIN = 32;     // latent + xyz
constexpr int HID = 128;
constexpr int H2 = 96;      // layer 2 shrinks so [h2 | x] stays 128 wide

// The f32 segments serve the plain versions; the kernels read the biases,
// heads, xyz columns and the kernels' own copy of the weights at OFF_TC.
constexpr int OFF_F0 = 0;                      // W0^T  [32][128]
constexpr int OFF_F1 = OFF_F0 + DIN * HID;     // W1^T  [128][128]
constexpr int OFF_F2 = OFF_F1 + HID * HID;     // W2^T  [128][96]
constexpr int OFF_F3 = OFF_F2 + HID * H2;      // W3^T  [128][128] (rows: h2 | x)
constexpr int OFF_G3 = OFF_F3 + HID * HID;     // W3[:, :96]  [128][96]
constexpr int OFF_G2 = OFF_G3 + HID * H2;      // W2    [96][128]
constexpr int OFF_G1 = OFF_G2 + H2 * HID;      // W1    [128][128]
constexpr int OFF_W3XYZ = OFF_G1 + HID * HID;  // W3[:, 125:128]  [128][3]
constexpr int OFF_W0XYZ = OFF_W3XYZ + HID * 3; // W0[:, 29:32]    [128][3]
constexpr int OFF_B0 = OFF_W0XYZ + HID * 3;
constexpr int OFF_B1 = OFF_B0 + HID;
constexpr int OFF_B2 = OFF_B1 + HID;
constexpr int OFF_B3 = OFF_B2 + H2;
constexpr int OFF_WSDF = OFF_B3 + HID;
constexpr int OFF_WSTD = OFF_WSDF + HID;
constexpr int OFF_BHEAD = OFF_WSTD + HID;      // b_sdf, b_std, 0, 0
constexpr int OFF_TC = OFF_BHEAD + 4;          // f0 f1 f2 f3 g3 g2 g1, the kernels' layout
// the f32 mode: the seven matrices split hi/lo in m16n8k8 fragment order
// (ops/decoder_fused._tc_frag)
constexpr int TC_FLOATS = 2 * (OFF_W3XYZ - OFF_F0);
constexpr int PACKED_SIZE = OFF_TC + TC_FLOATS;
// the bf16 mode's pack: the same f32 segments (weights rounded to bf16,
// biases f32), then the seven weight matrices in bf16, two to a float, in
// wgmma's shared-memory tiles (ops/decoder_fused._wgmma_tiles)
constexpr int PACKED_SIZE_BF16 = OFF_TC + TC_FLOATS / 4;
static_assert(OFF_TC % 4 == 0 && OFF_W3XYZ % 4 == 0,
              "the segments copied by TMA must be 16-byte aligned");
static_assert(OFF_B0 % 2 == 0 && OFF_B2 % 2 == 0 && OFF_WSDF % 2 == 0,
              "bias and head vectors are read as float2");

}  // namespace decoder_pack
