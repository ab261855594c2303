from dtdl_tpu_torch.train.state import TrainState, init_state  # noqa: F401
from dtdl_tpu_torch.train.step import (  # noqa: F401
    make_train_step, make_eval_step, make_predict_step, make_lm_train_step,
)
from dtdl_tpu_torch.train.loop import train_epoch, evaluate  # noqa: F401
from dtdl_tpu_torch.train.trainer import (  # noqa: F401
    Trainer, Trigger, Extension, Evaluator, LogReport, PrintReport,
    ProgressSummary, snapshot, dump_graph,
)
from dtdl_tpu_torch.train.fit import (  # noqa: F401
    Model, Callback, History, ModelCheckpoint, TensorBoard, PrintLR,
)
from dtdl_tpu_torch.train.solver import Solver  # noqa: F401
from dtdl_tpu_torch.train.estimator import (  # noqa: F401
    Estimator, EstimatorSpec, EvalSpec, ModeKeys, RunConfig, TrainSpec,
    train_and_evaluate,
)
