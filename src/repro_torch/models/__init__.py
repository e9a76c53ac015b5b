from repro_torch.models.model import ModelPlan, init_params, make_plan, train_loss

__all__ = ["ModelPlan", "init_params", "make_plan", "train_loss"]
