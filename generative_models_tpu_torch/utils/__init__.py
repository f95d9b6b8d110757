from generative_models_tpu_torch.utils.config import (  # noqa: F401
    AttrDict,
    dump_hps,
    global_defaults,
    parse_args,
    prefix_dict,
)
from generative_models_tpu_torch.utils.logger import (  # noqa: F401
    combine_imgs,
    count_vars,
    dump_logger,
    grid_image,
    make_logger,
    make_writer,
    to_numpy,
    write_grid,
    write_gridvid,
    write_image,
)
from generative_models_tpu_torch.utils.registry import (  # noqa: F401
    discover_models,
    register,
)
