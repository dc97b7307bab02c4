"""The float32 conv's weight gradient of the port on a card
(``layers.conv.conv2d_weight_gemm``, the im2col product that replaces
cuDNN's Winograd/FFT algorithms there), run here on the CPU in float64:
equal to autograd's weight gradient of ``F.conv2d`` within 1e-12, for
strides, paddings, groups and 1x1 kernels, in one chunk of samples and
in chunks of one sample, from NCHW and from channels_last memory; ``_Conv2dGemmWgrad``'s backward gives
autograd's input gradient too; and only stride-1 convs wider than 1x1
take that route."""

import pytest
import torch
import torch.nn.functional as F

from cxxnet_tpu_torch.layers.conv import (_Conv2dGemmWgrad, conv2d_weight_gemm,
                                          wgrad_by_gemm)


@pytest.mark.parametrize("n,c,h,o,k,s,p,g", [
    (4, 6, 9, 8, 3, 1, 1, 2), (2, 3, 11, 4, 5, 2, 2, 1),
    (3, 4, 7, 6, 1, 1, 0, 2), (2, 8, 12, 8, 7, 4, 3, 4)])
def test_weight_gemm_equals_autograd(n, c, h, o, k, s, p, g):
    gen = torch.Generator().manual_seed(n * 100 + k)
    x = torch.randn(n, c, h, h, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    w = torch.randn(o, c // g, k, k, dtype=torch.float64, generator=gen,
                    requires_grad=True)
    y = F.conv2d(x, w, stride=s, padding=p, groups=g)
    gy = torch.randn(y.shape, dtype=torch.float64, generator=gen)
    gx, gw = torch.autograd.grad(y, [x, w], gy)
    cl = torch.channels_last                   # the port's node layout
    for chunk_bytes in (1 << 28, 1):
        for xm, gm in ((x.detach(), gy), (x.detach().contiguous(
                memory_format=cl), gy.contiguous(memory_format=cl))):
            got = conv2d_weight_gemm(xm, gm, tuple(w.shape), s, (p, p), g,
                                     chunk_bytes=chunk_bytes)
            assert torch.allclose(got, gw, rtol=0, atol=1e-12)
    x2 = x.detach().clone().requires_grad_(True)
    w2 = w.detach().clone().requires_grad_(True)
    y2 = _Conv2dGemmWgrad.apply(x2, w2, s, (p, p), g)
    assert torch.equal(y2, y.detach())
    gx2, gw2 = torch.autograd.grad(y2, [x2, w2], gy)
    assert torch.allclose(gx2, gx, rtol=0, atol=1e-12)
    assert torch.allclose(gw2, gw, rtol=0, atol=1e-12)


def test_only_stride_one_convs_wider_than_one_take_the_gemm():
    assert wgrad_by_gemm(1, 3, 3) and wgrad_by_gemm(1, 5, 5)
    assert wgrad_by_gemm(1, 1, 3)
    assert not wgrad_by_gemm(1, 1, 1)
    assert not wgrad_by_gemm(2, 7, 7) and not wgrad_by_gemm(4, 11, 11)
