from repro_torch.kernels.fft.ops import (MAX_KERNEL_N, fft_kernel_c2c,
                                         fft_kernel_c2c_axis1,
                                         fft_kernel_c2c_mul,
                                         fft_kernel_c2c_t, fft_kernel_c2r,
                                         fft_kernel_r2c, fft_kernel_r2c_t,
                                         transpose_kernel)

__all__ = ["MAX_KERNEL_N", "fft_kernel_c2c", "fft_kernel_c2c_axis1",
           "fft_kernel_c2c_mul", "fft_kernel_c2c_t", "fft_kernel_c2r",
           "fft_kernel_r2c", "fft_kernel_r2c_t", "transpose_kernel"]
