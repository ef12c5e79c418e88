"""Plain PyTorch forwards of I3D, PWC-Net and RAFT: the benchmark's reference.

A frozen copy of the I3D, PWC-Net and RAFT parts of the repository's test
mirrors (``tools/torch_mirrors.py``), kept here so that a later change to the
program or to its tests cannot move the yardstick. Each layer table is
transcribed from the original reference sources named beside it, not from the
program. Plain ``torch`` operations in float32 only: the 81-tap cost volume is
81 shifted products, RAFT's lookup is ``grid_sample``; no kernel, cache or
batching of the program.

The seeded state dicts keep the mirrors' names, shapes and scales (convolution
weights and biases N(0, 0.05²), BatchNorm scales and variances U(0.5, 1.5),
shifts and means N(0, 0.05²)), but every leaf of a model is drawn on the given
device from one normal and one uniform draw of a ``torch.Generator`` seeded
with ``seed``, so that making the weights costs two calls a model.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# I3D: functional mirror (no nn.Module graph). The layer table below is
# transcribed independently from the original reference's
# models/i3d/i3d_src/i3d_net.py:179-224, not from any package of this
# repository, so a wrong channel count or missing branch there fails the
# comparison instead of propagating into the reference. Reads reference-named
# state dicts (conv3d_1a_7x7.conv3d.weight, mixed_3b.branch_1.0..., ...).
# ---------------------------------------------------------------------------


# (op, name, out_channels, kernel, stride) / (pool, name, kernel, stride) /
# (mixed, name, (b0, b1_reduce, b1, b2_reduce, b2, b3)); i3d_net.py:179-224
I3D_LAYERS = (
    ("conv", "conv3d_1a_7x7", 64, (7, 7, 7), (2, 2, 2)),
    ("pool", "maxPool3d_2a_3x3", (1, 3, 3), (1, 2, 2)),
    ("conv", "conv3d_2b_1x1", 64, (1, 1, 1), (1, 1, 1)),
    ("conv", "conv3d_2c_3x3", 192, (3, 3, 3), (1, 1, 1)),
    ("pool", "maxPool3d_3a_3x3", (1, 3, 3), (1, 2, 2)),
    ("mixed", "mixed_3b", (64, 96, 128, 16, 32, 32)),
    ("mixed", "mixed_3c", (128, 128, 192, 32, 96, 64)),
    ("pool", "maxPool3d_4a_3x3", (3, 3, 3), (2, 2, 2)),
    ("mixed", "mixed_4b", (192, 96, 208, 16, 48, 64)),
    ("mixed", "mixed_4c", (160, 112, 224, 24, 64, 64)),
    ("mixed", "mixed_4d", (128, 128, 256, 24, 64, 64)),
    ("mixed", "mixed_4e", (112, 144, 288, 32, 64, 64)),
    ("mixed", "mixed_4f", (256, 160, 320, 32, 128, 128)),
    ("pool", "maxPool3d_5a_2x2", (2, 2, 2), (2, 2, 2)),
    ("mixed", "mixed_5b", (256, 160, 320, 32, 128, 128)),
    ("mixed", "mixed_5c", (384, 192, 384, 48, 128, 128)),
)


def _tf_same_pad_5d(kernel, stride):
    """F.pad arg (w_lo, w_hi, h_lo, h_hi, t_lo, t_hi) for the (k - s) SAME rule."""
    flat = []
    for k, s in zip(reversed(kernel), reversed(stride)):
        p = max(k - s, 0)
        flat += [p // 2, p - p // 2]
    return flat


def _i3d_unit(sd, prefix, x, kernel=(1, 1, 1), stride=(1, 1, 1), bn=True, act=True):
    x = F.pad(x, _tf_same_pad_5d(kernel, stride))
    x = F.conv3d(x, sd[f"{prefix}.conv3d.weight"], sd.get(f"{prefix}.conv3d.bias"),
                 stride=tuple(stride))
    if bn:
        x = F.batch_norm(
            x,
            sd[f"{prefix}.batch3d.running_mean"],
            sd[f"{prefix}.batch3d.running_var"],
            sd[f"{prefix}.batch3d.weight"],
            sd[f"{prefix}.batch3d.bias"],
            training=False,
        )
    return F.relu(x) if act else x


def _i3d_pool(x, kernel, stride):
    x = F.pad(x, _tf_same_pad_5d(kernel, stride))
    return F.max_pool3d(x, kernel, stride, ceil_mode=True)


def i3d_forward(sd, x, features=True):
    """Functional I3D on (B, C, T, H, W); mirrors i3d_net.py numerics."""
    with torch.no_grad():
        for layer in I3D_LAYERS:
            kind, name = layer[0], layer[1]
            if kind == "conv":
                _, _, _, kernel, stride = layer
                x = _i3d_unit(sd, name, x, kernel, stride)
            elif kind == "pool":
                _, _, kernel, stride = layer
                x = _i3d_pool(x, kernel, stride)
            else:
                b0 = _i3d_unit(sd, f"{name}.branch_0", x)
                b1 = _i3d_unit(sd, f"{name}.branch_1.1",
                               _i3d_unit(sd, f"{name}.branch_1.0", x), (3, 3, 3))
                b2 = _i3d_unit(sd, f"{name}.branch_2.1",
                               _i3d_unit(sd, f"{name}.branch_2.0", x), (3, 3, 3))
                b3 = _i3d_unit(sd, f"{name}.branch_3.1", _i3d_pool(x, (3, 3, 3), (1, 1, 1)))
                x = torch.cat([b0, b1, b2, b3], dim=1)
        # reference kernel (2,7,7) == (2, H, W) at the supported 224-crop geometry
        x = F.avg_pool3d(x, (2, x.shape[3], x.shape[4]), (1, 1, 1))
        if features:
            return x.squeeze(3).squeeze(3).mean(2)
        x = _i3d_unit(sd, "conv3d_0c_1x1", x, bn=False, act=False)
        logits = x.squeeze(3).squeeze(3).mean(2)
        return torch.softmax(logits, 1), logits


# ---------------------------------------------------------------------------
# RAFT: functional torch mirror of the reference semantics (raft_src/). The
# shape table is transcribed independently from the reference source, not
# from any package of this repository. Sources: BasicEncoder channels 64→64/96/128→out
# (extractor.py:118-148), BasicMotionEncoder (update.py:83-91), SepConvGRU
# (update.py:37-46), FlowHead (update.py:10-14), mask head (update.py:124-128),
# RAFT dims hidden=context=128, corr 4 levels radius 4 (raft.py:55-67).
# ---------------------------------------------------------------------------


def raft_conv_shapes():
    """name → (cin, cout, kh, kw) conv / (c,) norm, reference state_dict names."""
    shapes = {}

    def encoder(prefix, out_dim, batch_norm):
        # conv1: 3→64 k7 s2 (extractor.py:135); residual stages 64,96,128 of two
        # blocks each, stride 2 on the first block of layer2/3 (:137-142)
        shapes[f"{prefix}.conv1"] = (3, 64, 7, 7)
        if batch_norm:
            shapes[f"{prefix}.norm1"] = (64,)
        cin = 64
        for stage, dim, stride in (("layer1", 64, 1), ("layer2", 96, 2), ("layer3", 128, 2)):
            for blk in (0, 1):
                s = stride if blk == 0 else 1
                p = f"{prefix}.{stage}.{blk}"
                shapes[f"{p}.conv1"] = (cin if blk == 0 else dim, dim, 3, 3)
                shapes[f"{p}.conv2"] = (dim, dim, 3, 3)
                if batch_norm:
                    shapes[f"{p}.norm1"] = (dim,)
                    shapes[f"{p}.norm2"] = (dim,)
                if blk == 0 and s != 1:
                    shapes[f"{p}.downsample.0"] = (cin, dim, 1, 1)
                    if batch_norm:
                        shapes[f"{p}.norm3"] = (dim,)
            cin = dim
        shapes[f"{prefix}.conv2"] = (128, out_dim, 1, 1)  # extractor.py:144

    encoder("fnet", 256, batch_norm=False)   # raft.py:129 output_dim=256, instance norm
    encoder("cnet", 128 + 128, batch_norm=True)  # hdim+cdim (raft.py:58-59)

    cor_planes = 4 * (2 * 4 + 1) ** 2  # levels × (2r+1)², update.py:85-86 → 324
    ub = "update_block"
    shapes[f"{ub}.encoder.convc1"] = (cor_planes, 256, 1, 1)  # update.py:87
    shapes[f"{ub}.encoder.convc2"] = (256, 192, 3, 3)         # update.py:88
    shapes[f"{ub}.encoder.convf1"] = (2, 128, 7, 7)           # update.py:89
    shapes[f"{ub}.encoder.convf2"] = (128, 64, 3, 3)          # update.py:90
    shapes[f"{ub}.encoder.conv"] = (64 + 192, 128 - 2, 3, 3)  # update.py:91
    gru_in = 128 + (128 + 128)  # hidden + input_dim(128+hidden), update.py:37-38,122
    for sfx, k in (("1", (1, 5)), ("2", (5, 1))):  # update.py:40-46
        for gate in ("convz", "convr", "convq"):
            shapes[f"{ub}.gru.{gate}{sfx}"] = (gru_in, 128, *k)
    shapes[f"{ub}.flow_head.conv1"] = (128, 256, 3, 3)  # update.py:13 hidden=256
    shapes[f"{ub}.flow_head.conv2"] = (256, 2, 3, 3)    # update.py:14
    shapes[f"{ub}.mask.0"] = (128, 256, 3, 3)           # update.py:126
    shapes[f"{ub}.mask.2"] = (256, 64 * 9, 1, 1)        # update.py:128
    return shapes


def _rconv(sd, name, x, stride=1, padding=0):
    return F.conv2d(x, sd[f"{name}.weight"], sd[f"{name}.bias"], stride, padding)


def _rnorm(sd, name, x, kind):
    if kind == "instance":
        return F.instance_norm(x)
    if kind == "batch":
        return F.batch_norm(x, sd[f"{name}.running_mean"], sd[f"{name}.running_var"],
                            sd[f"{name}.weight"], sd[f"{name}.bias"], training=False)
    return x


def _raft_encoder(sd, prefix, x, kind):
    x = F.relu(_rnorm(sd, f"{prefix}.norm1", _rconv(sd, f"{prefix}.conv1", x, 2, 3), kind))
    for stage, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2)):
        for blk in (0, 1):
            s = stride if blk == 0 else 1
            p = f"{prefix}.{stage}.{blk}"
            y = F.relu(_rnorm(sd, f"{p}.norm1", _rconv(sd, f"{p}.conv1", x, s, 1), kind))
            y = F.relu(_rnorm(sd, f"{p}.norm2", _rconv(sd, f"{p}.conv2", y, 1, 1), kind))
            if s != 1:
                x = _rnorm(sd, f"{p}.norm3", _rconv(sd, f"{p}.downsample.0", x, s, 0), kind)
            x = F.relu(x + y)
    return _rconv(sd, f"{prefix}.conv2", x, 1, 0)


def _raft_bilinear(img, coords):
    """Reference bilinear_sampler: pixel coords → grid_sample align_corners=True."""
    H, W = img.shape[-2:]
    xg = 2 * coords[..., 0] / (W - 1) - 1
    yg = 2 * coords[..., 1] / (H - 1) - 1
    return F.grid_sample(img, torch.stack([xg, yg], -1), align_corners=True)


def raft_torch_forward(sd, image1, image2, iters=20):
    """(B, 3, H, W) float RGB [0,255], H,W /8 → (B, 2, H, W) flow. Mirrors
    raft.py:115-174 numerics including the delta-grid dx/dy swap (corr.py:37-43)."""
    with torch.no_grad():
        x1 = 2 * (image1 / 255.0) - 1.0
        x2 = 2 * (image2 / 255.0) - 1.0
        f1 = _raft_encoder(sd, "fnet", x1, "instance").float()
        f2 = _raft_encoder(sd, "fnet", x2, "instance").float()

        B, D, H, W = f1.shape
        corr = torch.matmul(f1.view(B, D, -1).transpose(1, 2), f2.view(B, D, -1))
        corr = corr.view(B * H * W, 1, H, W) / (D ** 0.5)
        pyramid = [corr]
        for _ in range(3):
            corr = F.avg_pool2d(corr, 2, stride=2)
            pyramid.append(corr)

        cnet = _raft_encoder(sd, "cnet", x1, "batch")
        net, inp = torch.tanh(cnet[:, :128]), F.relu(cnet[:, 128:])

        dev = f1.device
        ys, xs = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                                indexing="ij")
        coords0 = torch.stack([xs, ys], 0).float()[None].repeat(B, 1, 1, 1)
        coords1 = coords0.clone()

        r = 4
        d = torch.linspace(-r, r, 2 * r + 1, device=dev)
        # reference delta swap: grid axis 0 carries the x displacement
        delta = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)  # (9,9,(dx,dy))

        for _ in range(iters):
            pts = coords1.permute(0, 2, 3, 1).reshape(B * H * W, 1, 1, 2)
            out = []
            for i, c in enumerate(pyramid):
                lvl = pts / 2 ** i + delta.view(1, 9, 9, 2)
                smp = _raft_bilinear(c, lvl)  # (BHW, 1, 9, 9)
                out.append(smp.view(B, H, W, 81))
            corr_feat = torch.cat(out, -1).permute(0, 3, 1, 2)

            flow = coords1 - coords0
            cor = F.relu(_rconv(sd, "update_block.encoder.convc1", corr_feat))
            cor = F.relu(_rconv(sd, "update_block.encoder.convc2", cor, 1, 1))
            flo = F.relu(_rconv(sd, "update_block.encoder.convf1", flow, 1, 3))
            flo = F.relu(_rconv(sd, "update_block.encoder.convf2", flo, 1, 1))
            mot = F.relu(_rconv(sd, "update_block.encoder.conv", torch.cat([cor, flo], 1), 1, 1))
            x = torch.cat([inp, torch.cat([mot, flow], 1)], 1)

            h = net
            for sfx, pad in (("1", (0, 2)), ("2", (2, 0))):
                hx = torch.cat([h, x], 1)
                z = torch.sigmoid(F.conv2d(hx, sd[f"update_block.gru.convz{sfx}.weight"],
                                           sd[f"update_block.gru.convz{sfx}.bias"], 1, pad))
                rr = torch.sigmoid(F.conv2d(hx, sd[f"update_block.gru.convr{sfx}.weight"],
                                            sd[f"update_block.gru.convr{sfx}.bias"], 1, pad))
                q = torch.tanh(F.conv2d(torch.cat([rr * h, x], 1),
                                        sd[f"update_block.gru.convq{sfx}.weight"],
                                        sd[f"update_block.gru.convq{sfx}.bias"], 1, pad))
                h = (1 - z) * h + z * q
            net = h
            delta_flow = _rconv(sd, "update_block.flow_head.conv2",
                                F.relu(_rconv(sd, "update_block.flow_head.conv1", net, 1, 1)), 1, 1)
            coords1 = coords1 + delta_flow

        mask = 0.25 * _rconv(sd, "update_block.mask.2",
                             F.relu(_rconv(sd, "update_block.mask.0", net, 1, 1)))
        # convex upsample (raft.py:100-111)
        flow = coords1 - coords0
        m = mask.view(B, 1, 9, 8, 8, H, W)
        m = torch.softmax(m, dim=2)
        up = F.unfold(8 * flow, [3, 3], padding=1).view(B, 2, 9, 1, 1, H, W)
        up = torch.sum(m * up, dim=2).permute(0, 1, 4, 2, 5, 3)
        return up.reshape(B, 2, 8 * H, 8 * W)


# ---------------------------------------------------------------------------
# PWC-Net: functional torch mirror of the reference semantics (pwc_src/). The
# tables below are transcribed independently from pwc_net.py, not from any
# package of this repository. torch-1.2 grid_sample semantics
# (align_corners=True) per the pinned conda_env_pwc.yml.
# ---------------------------------------------------------------------------

# PWCNet decoder attribute per pyramid level (pwc_net.py:215-221)
LEVEL_NAMES = {2: "moduleTwo", 3: "moduleThr", 4: "moduleFou", 5: "moduleFiv", 6: "moduleSix"}
# dblBackward warp scaling, indexed by the level whose decoder consumes it
# (pwc_net.py:124: [None,None,None,5.0,2.5,1.25,0.625,None][intLevel+1])
DEC_BACKWARD = {2: 5.0, 3: 2.5, 4: 1.25, 5: 0.625}

# Extractor per-level (out_channels) ×3 convs each (pwc_net.py:48-101)
_PWC_EXTRACTOR_CH = (16, 32, 64, 96, 128, 196)
# Decoder input width per level: 81 corr (+ feat + 2 flow + 2 upfeat below L6)
# (pwc_net.py:120-121: intCurrent = [None,None,81+32+2+2,81+64+2+2,81+96+2+2,81+128+2+2,81,None])
_PWC_DEC_CURRENT = {2: 81 + 32 + 4, 3: 81 + 64 + 4, 4: 81 + 96 + 4, 5: 81 + 128 + 4, 6: 81}
# DenseNet decoder head widths (pwc_net.py:128-158)
_PWC_DEC_OUT = (128, 128, 96, 64, 32)


def pwc_conv_shapes():
    """name → (cin, cout, kh, kw), 'T'-prefixed for ConvTranspose2d weights."""
    shapes = {}
    cin = 3
    for name, cout in zip(
        ("moduleOne", "moduleTwo", "moduleThr", "moduleFou", "moduleFiv", "moduleSix"),
        _PWC_EXTRACTOR_CH,
    ):
        p = f"moduleExtractor.{name}"
        shapes[f"{p}.0"] = (cin, cout, 3, 3)   # stride-2 conv (pwc_net.py:49)
        shapes[f"{p}.2"] = (cout, cout, 3, 3)
        shapes[f"{p}.4"] = (cout, cout, 3, 3)
        cin = cout

    for level in (6, 5, 4, 3, 2):
        mod = LEVEL_NAMES[level]
        cur = _PWC_DEC_CURRENT[level]
        if level < 6:
            prev = _PWC_DEC_CURRENT[level + 1]
            # ConvTranspose2d weights are (cin, cout, kh, kw) (pwc_net.py:123-124)
            shapes[f"{mod}.moduleUpflow"] = ("T", 2, 2, 4, 4)
            shapes[f"{mod}.moduleUpfeat"] = ("T", prev + sum(_PWC_DEC_OUT), 2, 4, 4)
        feat = cur
        for name, cout in zip(("moduleOne", "moduleTwo", "moduleThr", "moduleFou", "moduleFiv"),
                              _PWC_DEC_OUT):
            shapes[f"{mod}.{name}.0"] = (feat, cout, 3, 3)
            feat += cout
        shapes[f"{mod}.moduleSix.0"] = (feat, 2, 3, 3)

    # Refiner: 7 dilated convs from the level-2 dense feature (pwc_net.py:193-210)
    refiner_in = _PWC_DEC_CURRENT[2] + sum(_PWC_DEC_OUT)  # 565
    chans = (refiner_in, 128, 128, 128, 96, 64, 32, 2)
    for i, idx in enumerate(("0", "2", "4", "6", "8", "10", "12")):
        shapes[f"moduleRefiner.moduleMain.{idx}"] = (chans[i], chans[i + 1], 3, 3)
    return shapes


def _pwc_corr(f1, f2):
    """81-channel channel-mean cost volume, k = (dy+4)*9 + (dx+4) (correlation.py)."""
    B, C, H, W = f1.shape
    f2p = F.pad(f2, (4, 4, 4, 4))
    out = []
    for dy in range(-4, 5):
        for dx in range(-4, 5):
            shifted = f2p[:, :, 4 + dy : 4 + dy + H, 4 + dx : 4 + dx + W]
            out.append((f1 * shifted).mean(1))
    return torch.stack(out, 1)


def _pwc_warp(x, flow):
    """Backward warp with ones-mask thresholding (pwc_net.py:23-41)."""
    B, C, H, W = x.shape
    gx = torch.linspace(-1, 1, W, device=x.device).view(1, 1, 1, W).expand(B, 1, H, W)
    gy = torch.linspace(-1, 1, H, device=x.device).view(1, 1, H, 1).expand(B, 1, H, W)
    grid = torch.cat([gx, gy], 1)
    nflow = torch.cat([flow[:, :1] / ((W - 1) / 2), flow[:, 1:] / ((H - 1) / 2)], 1)
    xm = torch.cat([x, torch.ones(B, 1, H, W, device=x.device)], 1)
    out = F.grid_sample(xm, (grid + nflow).permute(0, 2, 3, 1),
                        mode="bilinear", padding_mode="zeros", align_corners=True)
    mask = out[:, -1:]
    mask = (mask > 0.999).float()
    return out[:, :-1] * mask


def _pwc_pyramid(sd, x):
    feats = []
    for name in ("moduleOne", "moduleTwo", "moduleThr", "moduleFou", "moduleFiv", "moduleSix"):
        p = f"moduleExtractor.{name}"
        x = F.leaky_relu(F.conv2d(x, sd[f"{p}.0.weight"], sd[f"{p}.0.bias"], 2, 1), 0.1)
        x = F.leaky_relu(F.conv2d(x, sd[f"{p}.2.weight"], sd[f"{p}.2.bias"], 1, 1), 0.1)
        x = F.leaky_relu(F.conv2d(x, sd[f"{p}.4.weight"], sd[f"{p}.4.bias"], 1, 1), 0.1)
        feats.append(x)
    return feats


def pwc_torch_forward(sd, image1, image2):
    """(B, 3, H, W) float RGB [0,255] → (B, 2, H, W) flow (pwc_net.py:226-263)."""
    with torch.no_grad():
        B, C, H, W = image1.shape
        x1 = image1[:, [2, 1, 0]] / 255.0
        x2 = image2[:, [2, 1, 0]] / 255.0
        H64 = int(math.floor(math.ceil(H / 64.0) * 64.0))
        W64 = int(math.floor(math.ceil(W / 64.0) * 64.0))
        if (H64, W64) != (H, W):
            x1 = F.interpolate(x1, size=(H64, W64), mode="bilinear", align_corners=False)
            x2 = F.interpolate(x2, size=(H64, W64), mode="bilinear", align_corners=False)

        pyr1 = _pwc_pyramid(sd, x1)
        pyr2 = _pwc_pyramid(sd, x2)

        est = None
        for level in (6, 5, 4, 3, 2):
            mod = LEVEL_NAMES[level]
            f1, f2 = pyr1[level - 1], pyr2[level - 1]
            if est is None:
                feat = F.leaky_relu(_pwc_corr(f1, f2), 0.1)
            else:
                flow = F.conv_transpose2d(est["flow"], sd[f"{mod}.moduleUpflow.weight"],
                                          sd[f"{mod}.moduleUpflow.bias"], 2, 1)
                upfeat = F.conv_transpose2d(est["feat"], sd[f"{mod}.moduleUpfeat.weight"],
                                            sd[f"{mod}.moduleUpfeat.bias"], 2, 1)
                warped = _pwc_warp(f2, flow * DEC_BACKWARD[level])
                vol = F.leaky_relu(_pwc_corr(f1, warped), 0.1)
                feat = torch.cat([vol, f1, flow, upfeat], 1)
            for name in ("moduleOne", "moduleTwo", "moduleThr", "moduleFou", "moduleFiv"):
                y = F.leaky_relu(F.conv2d(feat, sd[f"{mod}.{name}.0.weight"],
                                          sd[f"{mod}.{name}.0.bias"], 1, 1), 0.1)
                feat = torch.cat([y, feat], 1)
            flow = F.conv2d(feat, sd[f"{mod}.moduleSix.0.weight"], sd[f"{mod}.moduleSix.0.bias"], 1, 1)
            est = {"flow": flow, "feat": feat}

        x = est["feat"]
        for idx, d in zip(("0", "2", "4", "6", "8", "10"), (1, 2, 4, 8, 16, 1)):
            p = f"moduleRefiner.moduleMain.{idx}"
            x = F.leaky_relu(F.conv2d(x, sd[f"{p}.weight"], sd[f"{p}.bias"], 1, d, d), 0.1)
        refined = F.conv2d(x, sd["moduleRefiner.moduleMain.12.weight"],
                           sd["moduleRefiner.moduleMain.12.bias"], 1, 1)

        temp = est["flow"] + refined
        flow = 20.0 * F.interpolate(temp, size=(H, W), mode="bilinear", align_corners=False)
        flow[:, 0] *= float(W) / float(W64)
        flow[:, 1] *= float(H) / float(H64)
        return flow


# ---------------------------------------------------------------------------
# Seeded state dicts, drawn on the device
# ---------------------------------------------------------------------------

# leaf kinds: (draw, scale, shift) of N(0, 1) or U(0, 1)
_KINDS = {"w": ("normal", 0.05, 0.0), "scale": ("uniform", 1.0, 0.5)}


def i3d_leaf_specs(modality: str = "rgb", num_classes: int = 400) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every leaf of the reference-named I3D state dict,
    in the mirrors' order."""
    specs = []

    def unit(prefix, cin, cout, kernel, bn=True, bias=False):
        specs.append((f"{prefix}.conv3d.weight", (cout, cin, *kernel), "w"))
        if bias:
            specs.append((f"{prefix}.conv3d.bias", (cout,), "w"))
        if bn:
            specs.append((f"{prefix}.batch3d.weight", (cout,), "scale"))
            specs.append((f"{prefix}.batch3d.bias", (cout,), "w"))
            specs.append((f"{prefix}.batch3d.running_mean", (cout,), "w"))
            specs.append((f"{prefix}.batch3d.running_var", (cout,), "scale"))

    cin = {"rgb": 3, "flow": 2}[modality]
    for layer in I3D_LAYERS:
        kind, name = layer[0], layer[1]
        if kind == "conv":
            _, _, cout, kernel, _ = layer
            unit(name, cin, cout, kernel)
            cin = cout
        elif kind == "mixed":
            c0, c1r, c1, c2r, c2, c3 = layer[2]
            unit(f"{name}.branch_0", cin, c0, (1, 1, 1))
            unit(f"{name}.branch_1.0", cin, c1r, (1, 1, 1))
            unit(f"{name}.branch_1.1", c1r, c1, (3, 3, 3))
            unit(f"{name}.branch_2.0", cin, c2r, (1, 1, 1))
            unit(f"{name}.branch_2.1", c2r, c2, (3, 3, 3))
            unit(f"{name}.branch_3.1", cin, c3, (1, 1, 1))
            cin = c0 + c1 + c2 + c3
    unit("conv3d_0c_1x1", 1024, num_classes, (1, 1, 1), bn=False, bias=True)
    return specs


def raft_leaf_specs() -> List[Tuple[str, tuple, str]]:
    specs = []
    for name, shape in raft_conv_shapes().items():
        if len(shape) == 1:  # batch norm
            c = shape[0]
            specs += [(f"{name}.weight", (c,), "scale"), (f"{name}.bias", (c,), "w"),
                      (f"{name}.running_mean", (c,), "w"),
                      (f"{name}.running_var", (c,), "scale")]
        else:
            cin, cout, kh, kw = shape
            specs += [(f"{name}.weight", (cout, cin, kh, kw), "w"), (f"{name}.bias", (cout,), "w")]
    return specs


def pwc_leaf_specs() -> List[Tuple[str, tuple, str]]:
    specs = []
    for name, shape in pwc_conv_shapes().items():
        if shape[0] == "T":  # ConvTranspose2d weights are (cin, cout, kh, kw)
            _, cin, cout, kh, kw = shape
            specs.append((f"{name}.weight", (cin, cout, kh, kw), "w"))
        else:
            cin, cout, kh, kw = shape
            specs.append((f"{name}.weight", (cout, cin, kh, kw), "w"))
        specs.append((f"{name}.bias", (cout,), "w"))
    return specs


def seeded_state_dict(specs, seed: int, device="cpu") -> Dict[str, torch.Tensor]:
    """The leaves of ``specs`` from one normal and one uniform draw on
    ``device``, float32, each leaf a contiguous tensor of its own."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    sizes = {"normal": 0, "uniform": 0}
    for _, shape, kind in specs:
        sizes[_KINDS[kind][0]] += math.prod(shape)
    flat = {"normal": torch.randn(sizes["normal"], generator=g, device=device),
            "uniform": torch.rand(sizes["uniform"], generator=g, device=device)}
    at = {"normal": 0, "uniform": 0}
    sd = {}
    for name, shape, kind in specs:
        draw, scale, shift = _KINDS[kind]
        n = math.prod(shape)
        sd[name] = (flat[draw][at[draw]:at[draw] + n] * scale + shift).view(shape).clone()
        at[draw] += n
    return sd
