"""Faults planted in the program under a run, for the benchmark's tests:
each breaks the timed path the way a faulty change could, and the run's
check must then come out false. A rank of a data-parallel cell calls one
by name (``patch``) before it builds anything."""


def state_unchanged():
    """Adam returns the params and moments it was given."""
    from tinynerf_torch import optim

    def adam_update(grads, state, params, lr, **kw):
        return params, optim.AdamState(count=state.count + 1, mu=state.mu, nu=state.nu)

    optim.adam_update = adam_update


def half_batch():
    """The loss over the first half of the rays, its sum doubled (the mean
    over the rest, at the whole batch's scale)."""
    from tinynerf_torch.core import render
    whole = render.ray_loss

    def ray_loss(c_coarse, c_fine, c_true):
        h = c_true.shape[0] // 2
        return 2.0 * whole(c_coarse[:h], c_fine[:h], c_true[:h])

    render.ray_loss = ray_loss


def no_exchange():
    """The data-parallel step without its all-reduce: each rank steps on
    its own rows' gradient and loss."""
    from tinynerf_torch.parallel import mesh

    mesh.reduce_grads = lambda m, loss, grads: (loss, grads)


def altered_frame():
    """A frame whose first rows come back brighter than rendered."""
    from tinynerf_torch import eval as evallib
    make = evallib.make_frame_fn

    def make_frame_fn(*args, **kw):
        frame = make(*args, **kw)

        def altered(params, pose):
            img = frame(params, pose).copy()
            img[:2] += 0.5
            return img

        return altered

    evallib.make_frame_fn = make_frame_fn
