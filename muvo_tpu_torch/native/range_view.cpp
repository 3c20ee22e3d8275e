// Native host data-path kernels for the input pipeline.
//
// The per-frame host work (spherical range projection with a z-buffer, sparse
// voxel densification, CARLA 24-bit depth decode) dominates dataloading in the
// reference (SURVEY §3.1: "dataloader decode+range-projection (host)"); these
// C implementations replace the numpy sort-based versions on the hot path.
// Exposed via ctypes (muvo_tpu/native/__init__.py) with a pure-numpy fallback.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Spherical range projection with nearest-wins z-buffer.
// points: (n, 3) float32 ego-frame; sems: (n,) uint8.
// Outputs: depth (h*w) float32 (init -1), xyz (h*w*3) float32, sem (h*w) u8.
void range_project(const float* points, const uint8_t* sems, int64_t n,
                   int h, int w, float fov_down, float fov_up,
                   const float* lidar_pos,
                   float* out_depth, float* out_xyz, uint8_t* out_sem) {
    const float fov = fov_up - fov_down;
    const int64_t hw = (int64_t)h * w;
    for (int64_t i = 0; i < hw; ++i) out_depth[i] = -1.0f;
    memset(out_xyz, 0, hw * 3 * sizeof(float));
    memset(out_sem, 0, hw);

    for (int64_t i = 0; i < n; ++i) {
        const float px = points[3 * i + 0];
        const float py = points[3 * i + 1];
        const float pz = points[3 * i + 2];
        // undo ego conversion: back to raw CARLA lidar frame
        const float cx = px - lidar_pos[0];
        const float cy = -py - lidar_pos[1];
        const float cz = pz - lidar_pos[2];
        const float depth = sqrtf(cx * cx + cy * cy + cz * cz);
        if (depth <= 0.0f) continue;
        const float yaw = atan2f(-cy, cx);
        const float pitch = asinf(cz / depth);

        int u = (int)floorf(0.5f * (1.0f - yaw / (float)M_PI) * w);
        int v = (int)floorf((1.0f - (pitch - fov_down) / fov) * h);
        if (u < 0) u = 0; else if (u >= w) u = w - 1;
        if (v < 0) v = 0; else if (v >= h) v = h - 1;

        const int64_t pix = (int64_t)v * w + u;
        // nearest point wins
        if (out_depth[pix] < 0.0f || depth < out_depth[pix]) {
            out_depth[pix] = depth;
            out_xyz[3 * pix + 0] = px;
            out_xyz[3 * pix + 1] = py;
            out_xyz[3 * pix + 2] = pz;
            out_sem[pix] = sems[i];
        }
    }
}

// Sparse voxel rows -> dense uint8 grid.
void densify_voxels(const uint16_t* coords, const uint8_t* sems, int64_t k,
                    int x, int y, int z, uint8_t* out_grid) {
    memset(out_grid, 0, (int64_t)x * y * z);
    for (int64_t i = 0; i < k; ++i) {
        const int cx = coords[3 * i + 0];
        const int cy = coords[3 * i + 1];
        const int cz = coords[3 * i + 2];
        if (cx < 0 || cx >= x || cy < 0 || cy >= y || cz < 0 || cz >= z)
            continue;
        out_grid[((int64_t)cx * y + cy) * z + cz] = sems[i];
    }
}

// CARLA 24-bit RGB depth decode: (h*w, 3) uint8 RGB -> metres.
void decode_depth(const uint8_t* rgb, int64_t n, float* out_depth) {
    const double scale = 1000.0 / (256.0 * 256.0 * 256.0 - 1.0);
    for (int64_t i = 0; i < n; ++i) {
        const double v = 65536.0 * rgb[3 * i + 2] + 256.0 * rgb[3 * i + 1]
                         + rgb[3 * i + 0];
        out_depth[i] = (float)(v * scale);
    }
}

}  // extern "C"
