"""fluid_image_train: an image classifier trained through the port's
Fluid Program and Executor (paddle_tpu_torch.fluid), as the reference
repository's image benchmarks train it: model -> cross_entropy -> mean,
Momentum(0.01, 0.9), bf16 AMP (`program.amp`), one
`Executor.run(main, feed, fetch_list=[avg], return_numpy=False)` a step.

Set-up builds the program, runs its startup program (which makes the
optimizer's velocities and the batch-norm statistics), then writes the
benchmark's own weights from the seed into every parameter of the
scope, in creation order, checked shape by shape against the
reference's layout. It drives the first `checked_steps` steps on
distinct batches and keeps each step's loss, the velocities after the
first step (the first gradient as the optimizer got it) and each
parameter's change over those steps. The window cycles over the same
`distinct_batches` batches with no host read; `images_per_s` is every
image trained over the whole window, which ends in a sync."""

import time

import torch

from ..counts import resnet as counts
from ..lib import compare, dev, weights
from ..lib import lowp
from ..reference import resnet50 as ref


def image_program(fluid, model, shape, classes, amp, lr, mu):
    """(main, startup, avg, forward-only clone): image and label slots,
    model -> cross_entropy -> mean, Momentum(lr, mu); the clone is taken
    before the optimizer's ops."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        image = fluid.layers.data(name="image", shape=shape, dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        predict = model(image, classes)
        avg = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=predict, label=label))
        frozen = main.clone(for_test=True)
        fluid.optimizer.Momentum(learning_rate=lr, momentum=mu).minimize(avg)
    main.amp = frozen.amp = amp
    return main, startup, avg, frozen


# the reference in the program's place, in fp8 (the control) or, for the
# readings script's witness of bf16 rounding alone, in bf16
LOW = {"control": (lowp.fp8_conv2d, lowp.fp8_matmul, lowp.fp8_act),
       "bf16": (lowp.bf16_conv2d, lowp.bf16_matmul, lowp.bf16_act)}


def setup(cell):
    return FluidImageTrain(cell)


class FluidImageTrain(object):
    def __init__(self, cell):
        c, t = cell.config, cell.traffic
        self.cell, self.dev = cell, cell.device
        self.B, self.lr, self.mu = t["batch"], t["lr"], t["momentum"]
        self.depth, self.classes = c["depth"], c["num_classes"]
        self.lay = ref.layout(self.depth, self.classes)
        self.batches = weights.image_batches(
            cell.seed, t["distinct_batches"], self.B, c["image_shape"],
            self.classes, self.dev)
        self.first = self.batches[:t["checked_steps"]]
        self.n = 0
        self.counters = {}
        ws = weights.resnet_flat(self.lay, cell.seed, self.dev)
        if cell.mode in LOW:
            conv, mm, act = LOW[cell.mode]
            self.readings = ref.train_readings(
                self.lay, ws, self.first, self.lr, self.mu, self.depth,
                conv=conv, mm=mm, act=act)
            return
        import paddle_tpu_torch.fluid as fluid
        from paddle_tpu_torch.models import resnet

        torch.backends.cudnn.benchmark = True
        main, startup, self.avg, frozen = image_program(
            fluid, lambda x, k: resnet.resnet_imagenet(x, k, depth=self.depth),
            c["image_shape"], self.classes, c["amp"], self.lr, self.mu)
        block = main.global_block()
        self.counters["train_flops_per_image"] = counts.train_flops_per_image(
            counts.program_macs(block))
        self.counters["batch"] = self.B
        self.scope = fluid.Scope()
        self.fluid = fluid
        with fluid.scope_guard(self.scope):
            self.exe = fluid.Executor(fluid.CUDAPlace(0)
                                      if self.dev == "cuda"
                                      else fluid.CPUPlace())
            self.exe.run(startup)
        self.params = [p.name for p in block.all_parameters()]
        if len(self.params) != len(ws):
            raise ValueError("the program has %d parameters, the layout %d"
                             % (len(self.params), len(ws)))
        for name, w in zip(self.params, ws):
            have = tuple(self.scope.get(name).shape)
            if have != tuple(w.shape):
                raise ValueError("parameter %s is %s, the layout's leaf %s"
                                 % (name, have, tuple(w.shape)))
            self.scope.set(name, w)
        self.vel = {op.inputs["Param"][0]: op.inputs["Velocity"][0]
                    for op in block.ops if op.type == "momentum"}
        self.main = frozen if cell.fault == "unchanged" else main
        self.half = cell.fault == "half_batch"
        if cell.fault not in (None, "unchanged", "half_batch"):
            raise ValueError("no fault %r for fluid_image_train"
                             % cell.fault)
        self.readings = self._first_steps()

    def _run(self, batch):
        img, lab = batch
        if self.half:
            img, lab = img[:self.B // 2], lab[:self.B // 2]
        with self.fluid.scope_guard(self.scope):
            return self.exe.run(self.main, feed={"image": img, "label": lab},
                                fetch_list=[self.avg],
                                return_numpy=False)[0]

    def _state(self, names):
        return [self.scope.get(n).float() for n in names]

    def _first_steps(self):
        p0 = [x.clone() for x in self._state(self.params)]
        losses = []
        for k, batch in enumerate(self.first):
            losses.append(self._run(batch))
            if k == 0:
                grad = torch.stack([self.scope.get(self.vel[p]).float()
                                    .norm() for p in self.params])
        change = torch.stack([(b - a).norm() for a, b in
                              zip(p0, self._state(self.params))])
        return {"loss": [float(x.reshape(())) for x in losses],
                "grad_norms": grad.to(change.device),
                "change_norms": change}

    def sync(self):
        dev.sync(self.dev)

    def _steps(self, seconds=None, count=None):
        lag = dev.Lag(self.dev)
        n = 0
        self.sync()
        t0 = time.monotonic()
        while True:
            self._run(self.batches[(len(self.first) + self.n)
                                   % len(self.batches)])
            self.n += 1
            n += 1
            lag.mark()
            if (count is not None and n >= count) or (
                    seconds is not None
                    and time.monotonic() - t0 >= seconds):
                break
        self.sync()
        return n, time.monotonic() - t0

    def window(self, seconds):
        n, wall = self._steps(seconds=seconds)
        self.counters.update(window_steps=n, window_s=wall)
        return {"metrics": {"images_per_s": n * self.B / wall},
                "attempted": n, "failed": 0}

    def slice(self):
        n, _ = self._steps(count=3)
        self.counters.update(slice_steps=n)

    def release(self):
        self.scope = self.exe = self.main = None
        torch.backends.cudnn.benchmark = False

    def check(self):
        ws = weights.resnet_flat(self.lay, self.cell.seed, self.dev)
        want = ref.train_readings(self.lay, ws, self.first, self.lr, self.mu,
                                  self.depth)
        self.detail = compare.worst_leaves(self.readings, want)
        return compare.train_gaps(self.readings, want)
