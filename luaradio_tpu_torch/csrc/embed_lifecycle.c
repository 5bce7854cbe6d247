/*
 * Lifecycle program for the C embedding API (native/include/luaradio_tpu.h)
 * hosting the PyTorch port: the analog of native/tests/test_embed.c and of
 * the reference's embed/tests/test_api.c.
 *
 *   embed_lifecycle DEVICE REPO_ROOT OUT_PATH
 *
 * It checks the error paths (a script that raises, a script without a
 * `top`), then loads a script that builds a finite graph on DEVICE ("cpu"
 * or "cuda") writing OUT_PATH, starts it, reads its status (running),
 * waits for its end, reads its status again (stopped) and stops it; then
 * an endless graph, started and stopped.  Exit code 0 when every step
 * behaved; the caller checks OUT_PATH.  REPO_ROOT and OUT_PATH must not
 * contain a single quote.
 */

#include <stdio.h>
#include <string.h>

#include "luaradio_tpu.h"

#define CHECK(cond, what)                                                   \
    do {                                                                    \
        if (!(cond)) {                                                      \
            fprintf(stderr, "FAIL %s: %s\n", what,                          \
                    luaradio_tpu_strerror(radio));                          \
            return 1;                                                       \
        }                                                                   \
    } while (0)

static const char *finite_script =
    "import functools, sys\n"
    "sys.path.insert(0, '%s')\n"
    "import numpy as np\n"
    "import luaradio_tpu_torch as radio\n"
    "n = 1 << 20\n"
    "x = np.exp(1j * np.cumsum(np.full(n, 0.05))).astype(np.complex64)\n"
    "x.tofile('%s.iq')\n"
    "top = radio.CompositeBlock()\n"
    "top.connect(radio.IQFileSource('%s.iq', 'f32le', 1e6),\n"
    "            radio.FrequencyDiscriminatorBlock(1.25),\n"
    "            radio.LowpassFilterBlock(64, 1e5),\n"
    "            radio.DownsamplerBlock(4),\n"
    "            radio.RealFileSink('%s', 'f32le'))\n"
    "top.start = functools.partial(top.start, device='%s')\n";

static const char *endless_script =
    "import functools, sys\n"
    "sys.path.insert(0, '%s')\n"
    "import luaradio_tpu_torch as radio\n"
    "top = radio.CompositeBlock()\n"
    "top.connect(radio.SignalSource('exponential', 1e3, 1e6),\n"
    "            radio.FrequencyDiscriminatorBlock(1.25), radio.NopSink())\n"
    "top.start = functools.partial(top.start, device='%s')\n";

int main(int argc, char **argv) {
    if (argc != 4) {
        fprintf(stderr, "usage: %s DEVICE REPO_ROOT OUT_PATH\n", argv[0]);
        return 2;
    }
    const char *device = argv[1], *root = argv[2], *out = argv[3];
    char script[4096];

    printf("version: %s\n", luaradio_tpu_version());
    luaradio_tpu_t *radio = luaradio_tpu_new();
    if (radio == NULL) {
        fprintf(stderr, "FAIL new\n");
        return 1;
    }

    /* error paths: a failing script and one with no flow graph */
    CHECK(luaradio_tpu_load(radio, "raise ValueError('nope')\n") == -1,
          "a raising script loaded");
    CHECK(strstr(luaradio_tpu_strerror(radio), "nope") != NULL,
          "the script's error is not reported");
    CHECK(luaradio_tpu_load(radio, "x = 1\n") == -1,
          "a script without top loaded");
    CHECK(strstr(luaradio_tpu_strerror(radio), "top") != NULL,
          "the missing top is not reported");
    CHECK(luaradio_tpu_start(radio) == -1, "start with no graph");

    /* a finite graph: start, running, wait, stopped */
    snprintf(script, sizeof(script), finite_script, root, out, out, out,
             device);
    CHECK(luaradio_tpu_load(radio, script) == 0, "load");
    CHECK(luaradio_tpu_start(radio) == 0, "start");
    luaradio_tpu_status_t status;
    CHECK(luaradio_tpu_status(radio, &status) == 0, "status");
    printf("running: %u\n", status.running);
    CHECK(status.running == 1, "not running after start");
    CHECK(luaradio_tpu_wait(radio) == 0, "wait");
    CHECK(luaradio_tpu_status(radio, &status) == 0, "status");
    printf("running after wait: %u\n", status.running);
    CHECK(status.running == 0, "still running after wait");
    CHECK(luaradio_tpu_stop(radio) == 0, "stop after the end");

    /* an endless graph: start, running, stop, stopped */
    snprintf(script, sizeof(script), endless_script, root, device);
    CHECK(luaradio_tpu_load(radio, script) == 0, "load endless");
    CHECK(luaradio_tpu_start(radio) == 0, "start endless");
    CHECK(luaradio_tpu_status(radio, &status) == 0, "status");
    CHECK(status.running == 1, "endless graph not running");
    CHECK(luaradio_tpu_stop(radio) == 0, "stop endless");
    CHECK(luaradio_tpu_status(radio, &status) == 0, "status");
    printf("running after stop: %u\n", status.running);
    CHECK(status.running == 0, "still running after stop");

    luaradio_tpu_free(radio);
    printf("embed API lifecycle OK\n");
    return 0;
}
