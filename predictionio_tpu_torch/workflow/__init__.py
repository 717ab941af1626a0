"""The evaluation workflow (the counterpart of ``predictionio_tpu/workflow``):
the context, the workflow params and ``core_workflow.run_evaluation``; and
the training loop's step checkpoints (``checkpoint.StepCheckpointer``)."""
